"""PyTorch port, a host-array call's copies in and out (``pipeline``'s
``chunks``, ``stage_in``, ``upscale_host`` and ``fetch_host``).

A host array given to ``upscale_bgr_batch`` goes in as it is (HWC), becomes
planar on the device, and comes back as one C-contiguous, writable uint8
array that the caller owns, bit-equal to the tensor branch's result on the
same frames and to the JAX package's, whatever the input's strides or
integer dtype.  On the CPU it is the result tensor's own memory.  On a CUDA
device the call runs in chunks of frames (``chunks``), each staged through
pinned memory (``stage_in``), and the result lands in a block of torch's
pinned caching host allocator, reused across calls of one size class and
kept by a result that is held.  ``fetch_host.hits`` and ``.misses``, and
``upscale_host.calls`` and ``.chunks``, count CUDA calls only.
``cuda``-marked tests drive the chunked copies on the card.
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


def _counters():
    from srcnn_cpp_tpu_torch.pipeline import fetch_host, upscale_host

    return (fetch_host.hits, fetch_host.misses, upscale_host.calls,
            upscale_host.chunks)


def test_cpu_fetch_is_the_results_own_memory_and_moves_no_counter(
        monkeypatch):
    from srcnn_cpp_tpu_torch import pipeline

    before = _counters()
    t = torch.arange(24 * 4, dtype=torch.uint8).reshape(1, 4, 8, 3)
    monkeypatch.setattr(pipeline, "upscale_hwc", lambda *a: t)
    arr = pipeline.upscale_bgr_batch(_u8((1, 2, 4, 3), 3), 2.0,
                                     device="cpu")
    assert np.shares_memory(arr, t.numpy())
    monkeypatch.undo()
    pipeline.upscale_bgr_batch(_u8((4, 8, 12, 3), 3), 2.0, device="cpu")
    assert _counters() == before


@pytest.mark.parametrize("hw", [(1080, 1920), (36, 52)])
@pytest.mark.parametrize("b", [1, 2, 5, 32, 33])
def test_chunks_cover_the_batch_once_in_order(b, hw):
    from srcnn_cpp_tpu_torch.pipeline import (CHUNK_MIN_BYTES, CHUNKS,
                                              chunks)

    parts = chunks(b, *hw)
    assert [i for p in parts for i in range(b)[p]] == list(range(b))
    assert all(p.stop > p.start for p in parts)
    assert 1 <= len(parts) <= min(b, CHUNKS)
    frame = hw[0] * hw[1] * 3
    assert all((p.stop - p.start) * frame >= CHUNK_MIN_BYTES
               for p in parts[:-1])
    if frame * b <= CHUNK_MIN_BYTES:          # small frames: one chunk
        assert len(parts) == 1
    per = max(-(-b // CHUNKS), -(-CHUNK_MIN_BYTES // frame))
    assert all(p.stop - p.start == per for p in parts[:-1])


def test_chunks_of_the_host_cell():
    from srcnn_cpp_tpu_torch.pipeline import chunks

    assert chunks(32, 1080, 1920) == [slice(i, i + 2) for i in range(0, 32, 2)]
    assert chunks(1, 2160, 3840) == [slice(0, 1)]


def _read_only(x):
    x = x.copy()
    x.flags.writeable = False
    return x


STAGED = {**LAYOUTS, "read_only": _read_only}


@pytest.mark.parametrize("layout", sorted(STAGED))
def test_stage_in_copies_any_layout_as_u8_tensor_makes_it(layout):
    from srcnn_cpp_tpu_torch.pipeline import stage_in, u8_tensor

    frames = STAGED[layout](_FRAMES)
    block = torch.full(frames.shape, 7, dtype=torch.uint8)
    got = stage_in(frames, block, "cpu")
    assert torch.equal(got, u8_tensor(frames))
    block.fill_(7)
    got = stage_in(list(frames), block, "cpu")     # a sequence of frames
    assert torch.equal(got, u8_tensor(frames))


def test_stage_in_refuses_a_frame_of_another_shape():
    from srcnn_cpp_tpu_torch.pipeline import stage_in

    block = torch.empty((2, 14, 22, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shape"):
        stage_in([_FRAMES[0], _FRAMES[1, :1]], block, "cpu")


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


def _trace_events(fn, tmp_path) -> list:
    from srcnn_cpp_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)) as logdir:
        fn()
    return json.loads((Path(logdir) / "trace.json").read_text())[
        "traceEvents"]


def _copies(events, way):
    return sorted((e for e in events if e.get("cat") == "gpu_memcpy"
                   and way in e.get("name", "")), key=lambda e: e["ts"])


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.cuda
def test_cuda_host_array_goes_in_as_hwc_and_becomes_planar_on_the_card(
        tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import (chunks, upscale_bgr_batch,
                                              upscale_planar)

    w = _card_weights()
    frames = _u8((5, 1080, 1920, 3), 8)
    parts = chunks(*frames.shape[:3])
    assert len(parts) > 1
    upscale_bgr_batch(frames, 2.0, w, "cuda")      # builds before the trace
    got = None

    def call():
        nonlocal got
        got = upscale_bgr_batch(frames, 2.0, w, "cuda")

    events = _trace_events(call, tmp_path)

    def spans(name):
        return sorted((e for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") == name), key=lambda e: e["ts"])

    assert spans("srcnn.entry.host_transpose") == []
    stage, h2d_spans, planar_spans = (spans("srcnn.entry.stage_in"),
                                      spans("srcnn.entry.h2d"),
                                      spans("srcnn.entry.to_planar"))
    assert len(stage) == len(h2d_spans) == len(planar_spans) == len(parts)
    # one copy in a chunk, each of its frames' bytes, each from pinned memory
    h2d = _copies(events, "HtoD")
    assert [e["args"].get("bytes") for e in h2d] == [
        (p.stop - p.start) * frames[0].nbytes for p in parts], h2d
    assert sum(e["args"]["bytes"] for e in h2d) == frames.nbytes
    assert all("Pinned" in e["name"] for e in h2d), [e["name"] for e in h2d]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def launched_in(e, span):
        launch = launches.get(e["args"].get("correlation"))
        return launch is not None and _inside(launch, span)

    assert all(launched_in(c, s) for c, s in zip(h2d, h2d_spans))
    # each chunk's relayout to planar runs on the card after its copy in
    for copy, span in zip(h2d, planar_spans):
        relayout = [e for e in events if e.get("cat") == "kernel"
                    and launched_in(e, span)]
        assert len(relayout) == 1, [e["name"] for e in relayout]
        assert relayout[0]["ts"] >= copy["ts"] + copy["dur"]
    # the parent's bytes: transposed on the host, then copied in planar
    planar = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(frames, -1, 1))).cuda()
    ref = upscale_planar(planar, w, (2160, 3840)).permute(0, 2, 3, 1)
    assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["c_contiguous", "channels_reversed"])
def test_cuda_chunked_call_equals_the_tensor_branch(view):
    from srcnn_cpp_tpu_torch.pipeline import chunks, upscale_bgr_batch

    w = _card_weights()
    frames = LAYOUTS[view](_u8((5, 1080, 1920, 3), 9))
    sizes = [p.stop - p.start for p in chunks(*frames.shape[:3])]
    assert len(sizes) > 1 and len(set(sizes)) > 1  # the rule splits unevenly
    got = upscale_bgr_batch(frames, 2.0, w, "cuda")
    ref = upscale_bgr_batch(torch.from_numpy(np.ascontiguousarray(frames))
                            .cuda(), 2.0, w, "cuda")
    assert got.flags.c_contiguous and got.flags.writeable
    assert torch.from_numpy(got).is_pinned()
    assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.cuda
def test_cuda_counter_moves_by_one_call_and_its_chunks():
    from srcnn_cpp_tpu_torch.pipeline import (chunks, upscale_bgr,
                                              upscale_bgr_batch, upscale_host)

    w = _card_weights()
    frames = _u8((5, 1080, 1920, 3), 10)
    calls, sent = upscale_host.calls, upscale_host.chunks
    upscale_bgr_batch(frames, 2.0, w, "cuda")
    assert upscale_host.calls == calls + 1
    assert upscale_host.chunks == sent + len(chunks(5, 1080, 1920))
    upscale_bgr(frames[0], 2.0, w, "cuda")         # one frame, one chunk
    assert (upscale_host.calls, upscale_host.chunks) == (
        calls + 2, sent + len(chunks(5, 1080, 1920)) + 1)
    upscale_bgr_batch(torch.from_numpy(frames).cuda(), 2.0, w, "cuda")
    assert upscale_host.calls == calls + 2         # a tensor is not staged


@pytest.mark.cuda
def test_cuda_copies_overlap_the_kernels(tmp_path):
    from srcnn_cpp_tpu_torch.pipeline import upscale_bgr_batch

    w = _card_weights()
    frames = _u8((8, 1080, 1920, 3), 11)
    upscale_bgr_batch(frames, 2.0, w, "cuda")
    events = _trace_events(lambda: upscale_bgr_batch(frames, 2.0, w, "cuda"),
                           tmp_path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = _copies(events, "HtoD") + _copies(events, "DtoH")
    assert sum(e["args"]["bytes"] for e in copies) == frames.nbytes * 5
    overlapping = [c for c in copies if any(
        k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"] + k["dur"]
        for k in kernels)]
    assert overlapping, "no copy overlaps a kernel"
