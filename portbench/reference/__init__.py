"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, written from the reference binary's arithmetic
(shuwang127/SRCNN_Cpp, src/srcnn.cpp): OpenCV's fixed-point BGR <-> YCrCb,
OpenCV-4.6 INTER_CUBIC on uint8 planes, the SRCNN conv stack in float32
with TF32 off, and IntTrim's truncating quantization.  It imports nothing
of the program: every table and every packed weight is worked out again
here from the checkpoint file and the frames.

A configuration names its network's reference by the module's name
(``"reference"`` in ``configs/<config>.json``; ``srcnn_bgr`` for SRCNN),
and ``portbench.spec.reference`` loads it from this folder.  Such a module
provides:

* ``load(path, device) -> dict[str, Tensor]``: the checkpoint, read
  without the program;
* ``macs_per_pixel(shapes) -> int``: the network's multiply-accumulates
  per output pixel, from the shapes of ``load``'s tensors;
* ``upscale_frame(bgr_u8, weights, scale, tf32=False) -> bgr_u8``: the
  whole frame, BGR uint8 in and out; ``tf32=True`` is the control.

A configuration of another network brings its own ``reference/<name>.py``
as a new file, with its ``configs/<name>.json``, its checkpoint (or
seeded weights saved as a data file by a script kept beside them), its
traffic file and its readers; the program brings the runner in
``srcnn_cpp_tpu_torch/configs.py`` and the checkpoint loader that the
configuration's ``"program_weights"`` names.
"""
