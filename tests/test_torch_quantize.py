"""The port's int8 serving (ops/quantize.py, the int8 cache of
models/generate.py, the loader's ``quantize``/``kv_cache`` options)
against the JAX package's.

``quantize_array`` gives JAX's int8 values exactly (on the host path with
eps 1e-12 and on the KV path with eps 1e-8, inputs with exact ties and
all-zero rows) and its scales within 1 ulp; ``quantize_params`` gives
JAX's tree leaf for leaf; ``qeinsum`` and ``embed_lookup`` agree within
1e-5; ``generate()`` with int8 weights, an int8 cache or both gives JAX's
greedy tokens with its final logits within 1e-4, all at float32 on the
CPU.  The cosine checks of tests/test_quantize.py hold on the port:
int8 against the unquantized model, above 0.99."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import (
    TransformerConfig as JaxTransformerConfig,
)
from kubeflow_tpu.ops import quantize as jq
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.ops import quantize as pq
from kubeflow_tpu_torch.serving import loaders
from kubeflow_tpu_torch.serving.export import load_version

SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"


@pytest.fixture(scope="module")
def tree():
    jcfg = JaxTransformerConfig(dtype=jnp.float32, attention="dot", **SMALL)
    variables = JaxTransformer(jcfg).init(
        jax.random.key(5), np.zeros((1, 8), np.int32))
    return jcfg, jax.tree.map(np.asarray, nn.unbox(variables)["params"])


def _port_model(tree, quantize: bool):
    params = params_from_jax(tree)
    if quantize:
        params = pq.quantize_params(params)
    return load_params(
        Transformer(TransformerConfig(dtype=torch.float32, attention="dot",
                                      **SMALL), device="meta"), params)


def _inputs(seed: int, shape, ties: bool):
    """Seeded normal values.  With ``ties`` every value is an exact
    half-step (k + 0.5) * 2**-5 and every slice along either of the last
    two dims holds amax = 127 * 2**-5, so the scale is 2**-5 exactly and
    x / scale lands on k + 0.5, where rounding goes to even; one slice
    along each of those dims is all zero."""
    rng = np.random.default_rng(seed)
    if not ties:
        return rng.standard_normal(shape).astype(np.float32)
    step = 2.0 ** -5
    x = ((rng.integers(-126, 126, shape) + 0.5) * step).astype(np.float32)
    x[..., 0] = 127 * step
    x[..., 0, :] = -127 * step
    x[0, :, 5] = 0.0
    x[1, 2, :] = 0.0
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("path", ["host", "kv"])
def test_quantize_array_matches_jax(path, ties):
    x = _inputs(3 + ties, (4, 6, 40), ties)
    if path == "host":
        want_v, want_s = jq.quantize_array(x, (-2,), eps=1e-12, xp=np)
        got_v, got_s = pq.quantize_array(torch.from_numpy(x), (-2,),
                                         eps=1e-12)
    else:
        want_v, want_s = jax.jit(
            lambda a: jq.quantize_array(a, (-1,)))(jnp.asarray(x))
        got_v, got_s = pq.quantize_array(torch.from_numpy(x), (-1,))
    want_v, want_s = np.asarray(want_v), np.asarray(want_s)
    assert got_v.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_max_ulp(got_s.numpy(), want_s, maxulp=1)
    if ties:
        assert (want_s == 2.0 ** -5).sum() > want_s.size // 2
        assert (want_s < 1e-10).any()   # the all-zero slice: eps / 127


def test_quantize_params_matches_jax_tree(tree):
    _, jtree = tree
    want = jq.quantize_params(jtree)
    got = pq.quantize_params(params_from_jax(jtree))
    seen = 0
    for path, axes in pq.CONTRACTIONS.items():
        for prefix in ((), ("layers",)):
            node_w, node_g = want, got
            try:
                for key in prefix + path:
                    node_w, node_g = node_w[key], node_g[key]
            except KeyError:
                continue
            assert isinstance(node_g, pq.QTensor), path
            assert node_g.axes == node_w.axes == axes
            np.testing.assert_array_equal(node_g.values.numpy(),
                                          np.asarray(node_w.values))
            np.testing.assert_array_equal(node_g.scale.numpy(),
                                          np.asarray(node_w.scale))
            seen += 1
    assert seen == 6    # tied embeddings: no w_out
    assert not isinstance(got["layers"]["attn_norm"]["scale"], pq.QTensor)
    assert got["layers"]["attn_norm"]["scale"].dtype == torch.float32


def test_qeinsum_and_embed_lookup_match_jax(tree):
    _, jtree = tree
    jqt = jq.quantize_params(jtree)
    pqt = pq.quantize_params(params_from_jax(jtree))
    x = np.random.default_rng(0).standard_normal(
        (2, 3, SMALL["d_model"])).astype(np.float32)
    h = np.random.default_rng(1).standard_normal(
        (2, 3, SMALL["n_heads"], SMALL["head_dim"])).astype(np.float32)
    for eq, arg, key in (("bse,ehd->bshd", x, ("attn", "wq")),
                         ("bshd,hde->bse", h, ("attn", "wo"))):
        want = jq.qeinsum(eq, jnp.asarray(arg),
                          jqt["layers"][key[0]][key[1]][0], jnp.float32)
        got = pq.qeinsum(eq, torch.from_numpy(arg),
                         pqt["layers"][key[0]][key[1]][0], torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    toks = np.asarray([[1, 5, 7], [0, 127, 5]], np.int32)
    want = jq.embed_lookup(jqt["embed"], jnp.asarray(toks), jnp.float32)
    got = pq.embed_lookup(pqt["embed"], torch.from_numpy(toks).long(),
                          torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # The plain paths too.
    got = pq.embed_lookup(torch.tensor(jtree["embed"]),
                          torch.from_numpy(toks).long(), torch.float32)
    np.testing.assert_array_equal(got.numpy(), jtree["embed"][toks])


def test_qtensor_narrows_and_moves_in_step():
    qt = pq.QTensor(torch.arange(24, dtype=torch.int8).reshape(2, 3, 4),
                    torch.ones((2, 3)), (-1,))
    one = qt[1]
    assert one.shape == (3, 4) and one.scale.shape == (3,)
    assert one.axes == (-1,)
    assert torch.equal(one.values, qt.values[1])
    moved = qt.to("cpu")
    assert moved.device == torch.device("cpu")
    assert qt.nbytes == 24 + 6 * 4


@pytest.mark.parametrize("weights,cache", [
    ("int8", "model"), ("model", "int8"), ("int8", "int8")])
def test_generate_int8_matches_jax(tree, weights, cache):
    """Greedy tokens equal and final logits within 1e-4, but for int8
    weights over an int8 cache, whose logits agree within 1e-3: there the
    two packages' float32 k and v (equal to ~1e-4 of an int8 step, the
    dots summing in other orders) land on either side of a rounding tie
    in some runs (this prompt's among them), and one int8 step of a key or
    value moves the logits by up to ~1e-3
    (``test_int8_cache_differs_only_at_rounding_ties``)."""
    jcfg, jtree = tree
    jparams = jq.quantize_params(jtree) if weights == "int8" else jtree
    model = _port_model(jtree, weights == "int8")
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, SMALL["vocab_size"], (2, 9)).astype(np.int32)
    plen = np.asarray([9, 6], np.int32)   # a left-padded row too
    jd = jgen.DecodeConfig(max_new_tokens=8, kv_cache_dtype=cache)
    pd = pgen.DecodeConfig(max_new_tokens=8, kv_cache_dtype=cache)
    jt, jl = jgen.generate(jcfg, jparams, jnp.asarray(prompt), jd,
                           prompt_len=jnp.asarray(plen))
    pt, pl = pgen.generate(model, torch.from_numpy(prompt).long(), pd,
                           prompt_len=torch.from_numpy(plen))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    tol = 1e-3 if weights == cache == "int8" else 1e-4
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)


def test_int8_cache_differs_only_at_rounding_ties(tree):
    """The int8 cache's values agree between the packages wherever the
    float32 keys and values they quantize are not within float32 noise
    of a rounding tie: in the first layer (whose inputs are the prompt's
    embeddings in both), every int8 value that differs belongs to an
    element whose JAX value lies within 1e-3 of an int8 step from a
    tie, and such a difference does occur for this prompt."""
    jcfg, jtree = tree
    jparams = jq.quantize_params(jtree)
    model = _port_model(jtree, True)
    prompt = np.random.default_rng(7).integers(
        1, SMALL["vocab_size"], (2, 9)).astype(np.int32)
    jc = jgen.init_cache(jcfg, 2, 9)
    _, jc = jax.jit(lambda p, t, c: jgen._forward_with_cache(
        jcfg, p, t, c, 0))(jparams, jnp.asarray(prompt), jc)
    pc = pgen.init_cache(model.cfg, 2, 9, device="cpu")
    with torch.inference_mode():
        pgen._forward_with_cache(model, torch.from_numpy(prompt).long(),
                                 pc, 0)
    flips = 0
    for jside, pside in zip(jc, pc):
        jx = np.asarray(jside)[0]          # layer 0 [b, t, hkv, d]
        px = pside[0]
        jv, js = jq.quantize_array(jnp.asarray(jx), (-1,))
        pv, _ = pq.quantize_array(px, (-1,))
        differ = np.asarray(jv) != pv.numpy()
        ratio = jx / np.asarray(js)[..., None]
        to_tie = np.abs(np.abs(ratio) % 1.0 - 0.5)
        assert (to_tie[differ] < 1e-3).all()
        flips += int(differ.sum())
    assert flips >= 1


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                  + 1e-9))


@pytest.mark.parametrize("what", ["weights", "cache"])
def test_int8_tracks_the_unquantized_model(tree, what):
    """tests/test_quantize.py's cosine checks on the port: one step's
    logits of int8 weights (or an int8 cache over four steps) against
    the unquantized model's, above 0.99."""
    _, jtree = tree
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, SMALL["vocab_size"], (2, 8))).long()
    full = _port_model(jtree, False)
    if what == "weights":
        dec = pgen.DecodeConfig(max_new_tokens=1)
        _, want = pgen.generate(full, prompt, dec)
        _, got = pgen.generate(_port_model(jtree, True), prompt, dec)
    else:
        _, want = pgen.generate(full, prompt,
                                pgen.DecodeConfig(max_new_tokens=4))
        _, got = pgen.generate(full, prompt, pgen.DecodeConfig(
            max_new_tokens=4, kv_cache_dtype="int8"))
    assert np.isfinite(got.numpy()).all()
    assert _cosine(want.numpy(), got.numpy()) > 0.99


def test_unknown_cache_dtype_raises(tree):
    model = _port_model(tree[1], False)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        pgen.generate(model, torch.ones((1, 3), dtype=torch.long),
                      pgen.DecodeConfig(max_new_tokens=2,
                                        kv_cache_dtype="fp8"))


@pytest.mark.parametrize("config", [
    {"quantize": "int8"}, {"kv_cache": "int8"},
    {"quantize": "int8", "kv_cache": "int8"}],
    ids=["weights", "cache", "both"])
def test_loader_int8_config_serves_like_jax(tmp_path, tree, config):
    """An export naming ``quantize``/``kv_cache`` loads in the port with
    int8 weights on the device (no dequantized copy) or an int8 cache,
    and its predict gives JAX's loader's tokens."""
    from kubeflow_tpu.serving.export import load_version as jax_load

    jcfg, jtree = tree
    overrides = dict(SMALL, dtype="float32")
    base = tmp_path / "lm"
    jax_export(base, 1, {"params": jtree}, loader=JAX_LOADER,
               config=dict(config, model=overrides, max_new_tokens=6),
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    ppredict, _ = load_version(base, 1, device="cpu")
    jpredict, _ = jax_load(base, 1)
    spec = ppredict.engine_spec
    assert spec["decode"].kv_cache_dtype == config.get("kv_cache", "model")
    quantized = isinstance(spec["model"].layers[0].attn.wq, pq.QTensor)
    assert quantized == ("quantize" in config)
    if quantized:
        assert spec["model"].embed.values.dtype == torch.int8
        names = {n for n, _ in spec["model"].named_parameters()}
        assert not any(n.endswith(("wq", "wkv", "wo", "wi", "embed"))
                       for n in names)
    tokens = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    got = ppredict({"tokens": tokens})["tokens"]
    want = np.asarray(jpredict({"tokens": tokens})["tokens"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["quantize", "kv_cache"])
def test_loader_unknown_mode_raises(key):
    with pytest.raises(ValueError, match=key):
        loaders.lm_generate({key: "fp4"}, device="cpu")
