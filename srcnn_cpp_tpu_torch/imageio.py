"""Host-side image decode/encode (the reference's imread/imwrite sites).

The pieces of ``srcnn_cpp_tpu/imageio.py`` the port needs, copied (the port
never imports the JAX package).  The reference does disk I/O through OpenCV
(reference src/srcnn.cpp:462 ``imread``, :670 ``imwrite``); the cv2
binding is preferred, PIL is the fallback.  All in-memory images are BGR
uint8 HxWx3, matching the reference convention.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import cv2  # type: ignore

    _HAVE_CV2 = True
except ImportError:  # pragma: no cover - exercised only on cv2-less installs
    _HAVE_CV2 = False


def sniff_format(path: str | Path) -> str | None:
    """Magic-byte format detection (reference test.cpp:136-195 parity).

    Returns "jpeg", "png", "bmp", or None.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return None
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:2] == b"BM":
        return "bmp"
    return None


def conv_image(buf, w: int, h: int, d: int) -> np.ndarray:
    """Normalize an interleaved pixel buffer to 3-channel RGB uint8 [H,W,3].

    Mirrors the reference harness's ``convImage`` (reference
    src/test.cpp:34-134), the front-end that feeds ``ProcessSRCNN``:

    * ``d=1``  gray: replicated into R=G=B (test.cpp:47-60);
    * ``d=2``  RGB565 (native-u16): fields extracted as R=(px&0xF800)>>11,
      G=(px&0x07E0)>>5, B=px&0x001F — not expanded to 8-bit range
      (test.cpp:71-83), a quirk of the reference preserved here;
    * ``d=3``  passed through (test.cpp:121-128 ``copy()``);
    * ``d=4``  RGBA: alpha-premultiplied RGB, alpha dropped, float->u8 by
      C-cast truncation (test.cpp:95-108).
    """
    a = np.frombuffer(np.ascontiguousarray(buf), dtype=np.uint8) \
        if d != 2 else np.frombuffer(np.ascontiguousarray(buf), dtype=np.uint16)
    if d == 1:
        px = a.reshape(h, w)
        return np.repeat(px[..., None], 3, axis=-1)
    if d == 2:
        px = a.reshape(h, w).astype(np.uint16)
        r = ((px & 0xF800) >> 11).astype(np.uint8)
        g = ((px & 0x07E0) >> 5).astype(np.uint8)
        b = (px & 0x001F).astype(np.uint8)
        return np.stack([r, g, b], axis=-1)
    if d == 3:
        return a.reshape(h, w, 3).copy()
    if d == 4:
        px = a.reshape(h, w, 4)
        alp = px[..., 3:4].astype(np.float32) / 255.0
        return (px[..., :3].astype(np.float32) * alp).astype(np.uint8)
    raise ValueError(f"unsupported depth {d}; expected 1, 2, 3 or 4")


def decode_provenance() -> dict:
    """Identify the image decoder in use: ``{"decoder", "version"}``.

    JPEG decode differs between cv2 (libjpeg-turbo build settings) and
    PIL, which shifts eval PSNR in the 3rd decimal; the evaluation harness
    embeds this provenance in its output and warns when it differs from the
    decoder that minted the recorded numbers.
    """
    if _HAVE_CV2:
        return {"decoder": "cv2", "version": cv2.__version__}
    try:
        import PIL

        return {"decoder": "PIL", "version": PIL.__version__}
    except ImportError:  # pragma: no cover
        return {"decoder": "none", "version": ""}


def imread_bgr(path: str | Path) -> np.ndarray | None:
    """Decode an image file to BGR uint8 [H, W, 3]; None on failure."""
    path = str(path)
    if _HAVE_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return img if img is not None and img.size else None
    try:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
        return rgb[..., ::-1].copy()
    except (ImportError, OSError, ValueError):
        return None


def imwrite_bgr(path: str | Path, bgr: np.ndarray) -> bool:
    """Encode a BGR uint8 image to ``path`` (format from extension)."""
    path = str(path)
    bgr = np.asarray(bgr, dtype=np.uint8)
    if _HAVE_CV2:
        return bool(cv2.imwrite(path, bgr))
    try:
        from PIL import Image

        Image.fromarray(bgr[..., ::-1]).save(path)
        return True
    except (ImportError, OSError, ValueError, KeyError):
        return False
