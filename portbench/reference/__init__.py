"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, written from the reference binary's arithmetic
(shuwang127/SRCNN_Cpp, src/srcnn.cpp): OpenCV's fixed-point BGR <-> YCrCb,
OpenCV-4.6 INTER_CUBIC on uint8 planes, the SRCNN conv stack in float32
with TF32 off, and IntTrim's truncating quantization.  It imports nothing
of the program: every table and every packed weight is worked out again
here from the checkpoint file and the frames.
"""
