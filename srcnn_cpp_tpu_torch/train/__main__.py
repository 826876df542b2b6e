import sys

from .trainer import main

if __name__ == "__main__":
    sys.exit(main())
