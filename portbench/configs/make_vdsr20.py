"""Write ``vdsr20_seeded.npz``, the seeded weights of ``vdsr_1080p_to_4k``.

    python portbench/configs/make_vdsr20.py [out.npz]

VDSR at its published widths (arXiv:1511.04587): conv1 1->64, conv2 ..
conv19 64->64, conv20 64->1, all 3x3.  Weights He-normal (std
``sqrt(2 / (9 c_in))``, He et al., ICCV 2015, as the paper initialises
them) from NumPy's PCG64 seeded with :data:`SEED`, biases zero; conv20's
weights then scaled by :data:`CONV20_SCALE`, so that on the benchmark's
frames the residual ``255 f(x)`` has a standard deviation of 4-16 LSB and
under 1 % of Y' bytes clamp: He's scale alone gives this seed 4.9 LSB on
crops of the frames, 1.5 times that 7.4 (8.6 on whole 4K frames, 0.013 %
clamped; PERF.md).  The npz is written
member by member with a fixed date, uncompressed, so that the same seed
gives the same bytes.
"""

from __future__ import annotations

import io
import sys
import zipfile
from pathlib import Path

import numpy as np

SEED = 1511_04587
CONV20_SCALE = 1.5
DEPTH, CHANNELS = 20, 64
OUT = Path(__file__).with_name("vdsr20_seeded.npz")


def weights(seed: int = SEED) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, DEPTH + 1):
        cin = 1 if i == 1 else CHANNELS
        cout = 1 if i == DEPTH else CHANNELS
        w = rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2 / (9 * cin))
        if i == DEPTH:
            w = w * CONV20_SCALE
        out[f"conv{i}_w"] = w.astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(cout, np.float32)
    return out


def write(path: Path, arrays: dict[str, np.ndarray]) -> None:
    """An npz that ``np.load`` reads, its bytes fixed by ``arrays``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for name, a in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, a, allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1,
                                                             0, 0, 0))
            info.external_attr = 0o644 << 16
            z.writestr(info, buf.getvalue())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write(Path(argv[0]) if argv else OUT, weights())
    return 0


if __name__ == "__main__":
    sys.exit(main())
