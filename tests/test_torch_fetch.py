"""PyTorch port, the fetch of a host-array result (``pipeline.fetch_host``).

A host array given to ``upscale_bgr_batch`` comes back as one C-contiguous,
writable uint8 array that the caller owns, bit-equal to the tensor branch's
result on the same frames.  On the CPU it is the result tensor's own
memory; on a CUDA device it is a block of torch's pinned caching host
allocator, reused across calls of one size class and kept by a result that
is held.  ``fetch_host.hits`` and ``.misses`` count CUDA fetches only.
``cuda``-marked tests drive the pinned fetch on the card.
"""

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
