"""PyTorch port, the model family and the checkpoints, against the JAX package.

The same seeded NumPy weights and inputs go through both packages.
Tolerances, with their reasons:

* the family forward (:class:`SRCNN`) against JAX ``SRCNN().apply``: max
  |d| <= 1e-2 in the 0-255 domain, the K5 bar (the same float32 convs, sums
  in another order; measured on the CPU: 2.4e-4 for 9-5-5 on the checkpoint,
  outputs up to 455, and 8.0e-5 for the generic 16/8 9-3-5 config, outputs
  up to 147);
* ``infer_u8``: <=1 LSB (that float difference can cross an integer; 0
  measured);
* checkpoints and the header export: exact (bytes and bits).
"""

import numpy as np
import pytest
import torch

FAMILY_ATOL = 1e-2


def _jw(arrays):
    from srcnn_cpp_tpu.weights import SRCNNWeights as JW

    return JW(**{k: np.asarray(v, np.float32) for k, v in arrays.items()})


def _generic_arrays(n1=16, n2=8, f1=9, f2=3, f3=5, seed=3):
    # weights of std 1/sqrt(fan-in): every layer's output stays in the
    # 0-255 domain's range, so each layer matters
    from srcnn_cpp_tpu_torch.weights.loader import family_shapes

    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) / (np.sqrt(np.prod(s[1:]))
                                          if k.endswith("_w") else 1.0)
                ).astype(np.float32)
            for k, s in family_shapes(n1, n2, f1, f2, f3).items()}


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --- the model family ----------------------------------------------------------

@pytest.mark.parametrize("config", ["canonical", "generic"])
def test_family_forward_matches_jax(weights, config):
    from srcnn_cpp_tpu.models import SRCNN as JSRCNN
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    if config == "canonical":
        arrays, jm = weights.as_dict(), JSRCNN()
    else:
        arrays, jm = _generic_arrays(), JSRCNN(n1=16, n2=8, f1=9, f2=3, f3=5)
    model = SRCNN.from_weights(from_jax_params(arrays))
    assert model.config == (jm.n1, jm.n2, jm.f1, jm.f2, jm.f3)
    for shape, seed in (((24, 32), 0), ((2, 20, 37), 1)):
        y = _u8(shape, seed)
        with torch.no_grad():
            got = model(torch.from_numpy(y)).numpy()
        ref = np.asarray(jm.apply(_jw(arrays), y))
        assert got.shape == ref.shape == shape and got.dtype == np.float32
        d = float(np.abs(got - ref).max())
        assert d <= FAMILY_ATOL, (config, shape, d)
        mx = np.abs(model.infer_u8(torch.from_numpy(y)).numpy().astype(int)
                    - np.asarray(jm.infer_u8(_jw(arrays), y)).astype(int))
        assert mx.max() <= 1


def test_family_forward_on_canonical_equals_the_plain_serving_path(weights):
    # 9-1-5 through the family forward is srcnn_y_f32 (same ops, same order)
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.ops.srcnn import srcnn_y_f32
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    w = from_jax_params(weights)
    y = torch.from_numpy(_u8((2, 30, 41), 5))
    with torch.no_grad():
        assert torch.equal(SRCNN.from_weights(w)(y), srcnn_y_f32(y, w))


def test_num_params_and_config():
    from srcnn_cpp_tpu.models import SRCNN as JSRCNN
    from srcnn_cpp_tpu_torch.models import SRCNN

    assert SRCNN().num_params() == 8129   # 64*81+64 + 32*64+32 + 32*25+1
    for cfg in ((64, 32, 9, 1, 5), (16, 8, 9, 3, 5), (32, 16, 9, 5, 5)):
        m = SRCNN(*cfg)
        assert m.num_params() == JSRCNN(*cfg).num_params() == \
            sum(p.numel() for p in m.parameters())
        assert m.config == cfg


def test_reset_parameters_draws_from_the_generator():
    from srcnn_cpp_tpu_torch.models import SRCNN

    a = SRCNN().reset_parameters(torch.Generator().manual_seed(7))
    b = SRCNN().reset_parameters(torch.Generator().manual_seed(7))
    for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), k
        if k.endswith("_b"):
            assert not pa.any()
    std = float(a.conv1_w.detach().std())
    assert 0.8e-3 < std < 1.2e-3, std


def test_pretrained_only_for_the_canonical_config(weights):
    from srcnn_cpp_tpu_torch.models import SRCNN

    w = SRCNN().pretrained()
    assert np.array_equal(w.conv1_w.numpy(), np.asarray(weights.conv1_w))
    assert torch.equal(SRCNN.from_weights().conv3_w, w.conv3_w)
    with pytest.raises(ValueError):
        SRCNN(n1=16, n2=8).pretrained()


def test_weights_round_trip_through_the_model(weights):
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    w = from_jax_params(_generic_arrays())
    back = SRCNN.from_weights(w).weights()
    assert back.config == (16, 8, 9, 3, 5)
    for k, v in w.as_dict().items():
        assert torch.equal(getattr(back, k), v), k


def test_from_jax_params_takes_the_family_and_refuses_the_rest():
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    arrays = _generic_arrays()
    assert from_jax_params(arrays).config == (16, 8, 9, 3, 5)
    bad = dict(arrays, conv2_b=np.zeros(7, np.float32))       # n2 mismatch
    with pytest.raises(ValueError):
        from_jax_params(bad)
    bad = dict(arrays, conv1_w=np.zeros((16, 1, 9, 7), np.float32))
    with pytest.raises(ValueError):
        from_jax_params(bad)
    bad = dict(arrays, conv3_w=np.zeros((2, 8, 5, 5), np.float32))
    with pytest.raises(ValueError):
        from_jax_params(bad)


def test_fused_kernels_refuse_other_configs():
    from srcnn_cpp_tpu_torch.ops.cuda_srcnn import srcnn_y_fused
    from srcnn_cpp_tpu_torch.weights import from_jax_params

    w = from_jax_params(_generic_arrays())
    with pytest.raises(ValueError):
        srcnn_y_fused(torch.zeros((8, 8), dtype=torch.uint8), w)


# --- checkpoints ---------------------------------------------------------------

def test_the_ports_checkpoint_equals_the_jax_packages():
    from srcnn_cpp_tpu.weights import WEIGHTS_NPZ
    from srcnn_cpp_tpu_torch.weights import weights_npz

    import srcnn_cpp_tpu_torch

    ours = weights_npz()
    assert ours.parent.parent == __import__("pathlib").Path(
        srcnn_cpp_tpu_torch.__file__).parent
    with np.load(ours) as a, np.load(WEIGHTS_NPZ) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_npz_round_trip_and_cross_package(tmp_path):
    from srcnn_cpp_tpu.weights import load_weights as jax_load
    from srcnn_cpp_tpu_torch.weights import from_jax_params, load_weights
    from srcnn_cpp_tpu_torch.weights.checkpoint import save_npz

    w = from_jax_params(_generic_arrays())
    p = tmp_path / "ck.npz"
    save_npz(p, w)
    back, jback = load_weights(p), jax_load(p)
    for k, v in w.as_dict().items():
        assert torch.equal(getattr(back, k), v), k
        assert np.array_equal(getattr(jback, k), v.numpy()), k


def _adam_run(model, batches, state=None):
    from srcnn_cpp_tpu_torch.train import make_train_step

    opt = torch.optim.Adam(model.parameters(), lr=1e-4, eps=1e-8)
    if state is not None:
        opt.load_state_dict(state)
    step = make_train_step(model, opt)
    return opt, [step(x, t) for x, t in batches]


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path, weights):
    from srcnn_cpp_tpu_torch.models import SRCNN
    from srcnn_cpp_tpu_torch.weights import from_jax_params
    from srcnn_cpp_tpu_torch.weights.checkpoint import (load_checkpoint,
                                                        save_checkpoint)

    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 256, (4, 24, 24), dtype=np.uint8),
                rng.integers(0, 256, (4, 24, 24), dtype=np.uint8))
               for _ in range(3)]
    w0 = from_jax_params(weights)
    straight = SRCNN.from_weights(w0)
    _, losses = _adam_run(straight, batches)

    first = SRCNN.from_weights(w0)
    opt, head = _adam_run(first, batches[:2])
    p = tmp_path / "run.pt"
    save_checkpoint(p, first.weights(), opt.state_dict(), step=2,
                    losses=head)
    ck = load_checkpoint(p)
    assert ck["step"] == 2 and ck["losses"] == head == losses[:2]
    resumed = SRCNN.from_weights(ck["weights"])
    _, tail = _adam_run(resumed, batches[2:], ck["optimizer"])
    assert tail == losses[2:]
    for (k, a), b in zip(straight.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), k


def test_header_export_equals_the_jax_export_and_reparses(tmp_path, weights):
    from srcnn_cpp_tpu.weights.checkpoint import \
        export_convdata_header as jax_export
    from srcnn_cpp_tpu.weights.parse_convdata import parse_convdata
    from srcnn_cpp_tpu_torch.weights import from_jax_params
    from srcnn_cpp_tpu_torch.weights.checkpoint import export_convdata_header

    rng = np.random.default_rng(8)
    perturbed = {k: (np.asarray(v) * (1 + 1e-3 * rng.standard_normal(
        np.shape(v)))).astype(np.float32) for k, v in weights.as_dict().items()}
    for arrays in (weights.as_dict(), perturbed):
        ours, theirs = tmp_path / "ours.h", tmp_path / "theirs.h"
        export_convdata_header(ours, from_jax_params(arrays))
        jax_export(theirs, _jw(arrays))
        assert ours.read_bytes() == theirs.read_bytes()
        for k, v in parse_convdata(ours).items():
            assert np.array_equal(v, np.asarray(arrays[k])), k
