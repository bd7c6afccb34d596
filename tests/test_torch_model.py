"""The port's dense model against the reference's, on bridged parameters of
a reduced SmolLM (2 layers, d_model 64, f32): ``forward`` and
``paged_step`` logits, float and with ``int8`` W4A4+LRC QLinears, and the
bridge's round trip.

Tolerance: the two frameworks sum matmuls, softmax and norms in different
orders, so f32 logits differ by a few ulp of their scale per layer
(measured: 4e-7 on logits of order 0.6).  1e-4 absolute leaves margin for
that and is far below any real fault.  With ``int8`` QLinears the codes
are computed bitwise alike from inputs that differ by those ulps; a code
that flipped at a rounding boundary would show here, and with the fixed
seed none does."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.models import model
from torch_parity import configs, jax_params, jax_qlinears, to_numpy_tree

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def _close(got, want):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    else:
        assert a == b, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_bitwise(dtype):
    jcfg, _ = configs(dtype=dtype)
    jparams = jax_params(jcfg)
    tree = to_numpy_tree(jax_qlinears(jcfg, jparams))
    ported = bridge.params_from_jax(tree, device="cpu")
    assert len(ported["layers"]) == jcfg.n_layers
    assert ported["layers"][0]["attn"]["wq"].u.dtype == torch.bfloat16
    if dtype == "bfloat16":
        assert ported["embed"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(ported, bf16_dtype=ml_dtypes.bfloat16)
    _leaves_equal(tree, back)


def test_bridge_requires_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_jax({"embed": np.zeros((2, 2), np.float32)})


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_logits(setup, kind):
    jcfg, tcfg, trees, ported = setup
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    want = np.asarray(jax_model.forward(jcfg, trees[kind],
                                        {"tokens": jnp.asarray(toks, jnp.int32)}))
    got = model.forward(tcfg, ported[kind], {"tokens": torch.from_numpy(toks)})
    _close(got.numpy(), want)


def _paged_inputs(cfg, rng):
    """Two requests on shuffled pages of a pool full of finite garbage
    (the null page included): a 6-token prefill chunk for row 0 (5 real
    tokens, one padding), 3 tokens for row 1 (the rest padding)."""
    page, n_pages, mpb = 4, 9, 3
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    pool = {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((2, mpb), np.int32)
    table[0, :2], table[1, :1] = ids[:2], ids[2:3]
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    positions = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0]], bool)
    srow = np.array([4, 2], np.int32)
    return pool, table, tokens, positions, valid, srow


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_paged_step_logits_and_pages(setup, kind):
    jcfg, tcfg, trees, ported = setup
    rng = np.random.default_rng(2)
    pool, table, tokens, positions, valid, srow = _paged_inputs(jcfg, rng)
    steps = [(tokens, positions, valid, srow, False)]
    # then one batched decode step: row 0 at position 5, row 1 inactive
    steps.append((tokens[:, :1], np.array([[5], [3]], np.int32),
                  np.array([[1], [0]], bool), np.zeros(2, np.int32), True))
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    for tok, pos, val, sr, decode in steps:
        want, jpool = jax_model.paged_step(
            jcfg, trees[kind], jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(val), jpool, jnp.asarray(table),
            None if decode else jnp.asarray(sr))
        got, tpool = model.paged_step(
            tcfg, ported[kind], torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(val), tpool, torch.from_numpy(table),
            None if decode else torch.from_numpy(sr))
        got, want = got.numpy(), np.asarray(want)
        if decode:  # the inactive row's output is garbage both sides ignore
            got, want = got[:1], want[:1]
        _close(got, want)
    # every page a request owns holds the same k/v; the rest is untouched
    # garbage (the null page may differ: both write padding rows there)
    for leaf in ("k", "v"):
        got, want = tpool[leaf].numpy(), np.asarray(jpool[leaf])
        owned = table[table > 0]
        np.testing.assert_allclose(got[:, owned], want[:, owned], rtol=0,
                                   atol=ATOL)
        free = sorted(set(range(1, got.shape[1])) - set(owned.tolist()))
        assert np.array_equal(got[:, free], pool[leaf][:, free])
