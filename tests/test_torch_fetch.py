"""PyTorch port, the fetch of a host-array result (``pipeline.fetch_host``).

A host array given to ``upscale_bgr_batch`` goes in as it is (HWC, with one
host copy first only when it is not C-contiguous uint8), becomes planar on
the device, and comes back as one C-contiguous, writable uint8 array that
the caller owns, bit-equal to the tensor branch's result on the same frames
and to the JAX package's, whatever the input's strides or integer dtype.
On the CPU it is the result tensor's own memory; on a CUDA device it is a
block of torch's pinned caching host allocator, reused across calls of one
size class and kept by a result that is held.  ``fetch_host.hits`` and
``.misses`` count CUDA fetches only.  ``cuda``-marked tests drive the
pinned fetch and the copy in on the card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape,scale", [((1, 12, 16, 3), 2.0),
                                         ((2, 9, 13, 3), 1.5),
                                         ((3, 8, 10, 3), 3.0)])
def test_host_array_result_matches_the_tensor_branch(shape, scale):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    frames = _u8(shape, 1)
    got = upscale_bgr_batch(frames, scale, device="cpu")
    ref = upscale_bgr_batch(torch.from_numpy(frames), scale, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.flags.c_contiguous and got.flags.writeable
    assert np.array_equal(got, ref.numpy())


_FRAMES = _u8((2, 14, 22, 3), 3)
LAYOUTS = {"c_contiguous": lambda x: x,
           "channels_reversed": lambda x: x[..., ::-1],
           "strided_rows": lambda x: x[:, ::2],
           "fortran_order": np.asfortranarray,
           "int16": lambda x: x.astype(np.int16)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_array_of_any_layout_matches_the_tensor_branch_and_jax(
        layout, weights):
    from srcnn_cpp_tpu.pipeline import upscale_bgr_batch as jax_batch
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    frames = LAYOUTS[layout](_FRAMES)
    w = from_jax_params(weights)
    got = upscale_bgr_batch(frames, 2.0, w, device="cpu")
    tensor = upscale_bgr_batch(torch.from_numpy(
        np.array(frames, dtype=np.uint8)), 2.0, w, device="cpu")
    ref = np.asarray(jax_batch(frames, 2.0, weights, kernel="xla",
                               resize="exact"))
    assert got.flags.c_contiguous and got.dtype == np.uint8
    assert np.array_equal(got, tensor.numpy())
    assert np.array_equal(got, ref)


def test_host_array_result_shares_no_memory_with_the_input():
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr, upscale_bgr_batch

    frames = _u8((2, 10, 14, 3), 2)
    out = upscale_bgr_batch(frames, 2.0, device="cpu")
    assert not np.shares_memory(out, frames)
    one = upscale_bgr(frames[0], 2.0, device="cpu")
    assert not np.shares_memory(one, frames)
    assert one.flags.writeable and np.array_equal(one, out[0])


def test_cpu_fetch_is_the_results_own_memory_and_moves_no_counter():
    from srcnn_cpp_tpu_torch.pipeline import fetch_host, upscale_bgr_batch

    hits, misses = fetch_host.hits, fetch_host.misses
    t = torch.arange(24, dtype=torch.uint8).reshape(1, 2, 4, 3)
    arr = fetch_host(t)
    assert np.shares_memory(arr, t.numpy())
    upscale_bgr_batch(_u8((1, 8, 12, 3), 3), 2.0, device="cpu")
    assert (fetch_host.hits, fetch_host.misses) == (hits, misses)


# --- on the card ---------------------------------------------------------------

def _card_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from srcnn_cpp_tpu_torch.weights import load_weights

    return load_weights(device="cuda")


@pytest.mark.cuda
def test_cuda_host_array_result_is_pinned_and_equals_the_tensor_branch():
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    w = _card_weights()
    frames = _u8((3, 36, 52, 3), 4)
    got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    ref = upscale_bgr_batch(torch.from_numpy(frames).cuda(), 2.0, w, "cuda")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.flags.c_contiguous and got.flags.writeable
    assert torch.from_numpy(got).is_pinned()
    assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.cuda
def test_cuda_dropped_results_reuse_the_pinned_cache():
    from srcnn_cpp_tpu_torch.pipeline import fetch_host, upscale_bgr_batch

    w = _card_weights()
    frames = _u8((2, 40, 60, 3), 5)
    for _ in range(2):                      # warm: the cache holds a block
        upscale_bgr_batch(frames, 2.0, w, "cuda")
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    hits, misses = fetch_host.hits, fetch_host.misses
    for _ in range(4):
        upscale_bgr_batch(frames, 2.0, w, "cuda")
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert fetch_host.misses == misses
    assert fetch_host.hits == hits + 4


@pytest.mark.cuda
def test_cuda_held_result_is_unchanged_by_the_next_call():
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    w = _card_weights()
    a, b = _u8((2, 36, 52, 3), 6), _u8((2, 36, 52, 3), 7)
    held = upscale_bgr_batch(a, 2.0, w, "cuda")
    before = held.copy()
    nxt = upscale_bgr_batch(b, 2.0, w, "cuda")
    assert not np.shares_memory(held, nxt)
    assert np.array_equal(held, before)
    assert not np.array_equal(nxt, before)
    del nxt                                 # its block goes back to the cache
    upscale_bgr_batch(b, 2.0, w, "cuda")
    assert np.array_equal(held, before)


@pytest.mark.cuda
def test_cuda_host_array_goes_in_as_hwc_and_becomes_planar_on_the_card(
        tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch, upscale_planar
    from srcnn_cpp_tpu_torch.utils.profiling import trace

    w = _card_weights()
    frames = _u8((3, 36, 52, 3), 8)
    upscale_bgr_batch(frames, 2.0, w, "cuda")      # builds before the trace
    with trace(str(tmp_path)) as logdir:
        got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    events = json.loads((Path(logdir) / "trace.json").read_text())[
        "traceEvents"]

    def spans(name):
        return [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == name]

    def inside(inner, outer):
        return (outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    assert spans("srcnn.entry.host_transpose") == []
    (h2d_span,), (planar_span,) = (spans("srcnn.entry.h2d"),
                                   spans("srcnn.entry.to_planar"))
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    assert [e["args"].get("bytes") for e in h2d] == [frames.nbytes], h2d
    assert inside(h2d[0], h2d_span)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    relayout = [e for e in events if e.get("cat") == "kernel"
                and (launch := launches.get(e["args"].get("correlation")))
                and inside(launch, planar_span)]
    assert len(relayout) == 1, [e["name"] for e in relayout]
    assert relayout[0]["ts"] >= h2d[0]["ts"] + h2d[0]["dur"]
    # the parent's bytes: transposed on the host, then copied in planar
    planar = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(frames, -1, 1))).cuda()
    ref = upscale_planar(planar, w, (72, 104)).permute(0, 2, 3, 1)
    assert np.array_equal(got, ref.cpu().numpy())
