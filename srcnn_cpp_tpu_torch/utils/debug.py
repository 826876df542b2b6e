"""The reference binary's exit-code contract.

A copy of ``srcnn_cpp_tpu/utils/debug.py::EXIT_CODES``
(srcnn.cpp:479,493,526,555,684, negative codes mapped to POSIX-positive
values).  The JAX package's NaN guards have no counterpart here yet.
"""

#: reference exit-code contract (negative codes -> POSIX-positive)
EXIT_CODES = {
    "load_or_scale": 1,   # ref -1: image load / scale failure
    "colorspace": 2,      # ref -2: cvtColor failure
    "split": 3,           # ref -3: channel split failure
    "empty_output": 10,   # ref -10
}
