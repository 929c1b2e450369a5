"""The port's MoE family (granite-moe-3b-a800m, mixtral-8x22b) against the
JAX reference on the CPU: configs, the experts' quant groups, capacity,
routing, dispatch and combine, ``moe_apply`` and its aux loss, the model
steps and the engine, from the same numpy inputs made from a seed.

The reference's capacity drops are its semantics: at the published factor
1.25 both packages drop the same assignments (held here with at least one
drop asserted); at the dropless factor ``n_experts / top_k`` nothing
drops, and a chunked step equals sequential decode.

Tolerances: f32 at 1e-5 for one MoE layer and its aux (sums taken in
another order by another library), 1e-4 for logits and caches through
the model, as ``test_torch_model.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.compiler import quantize_model  # noqa: E402
from repro_torch.core.quant import QuantizedTensor, quantize  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ffn_fused, moe_experts, moe_route, ops, w4a16_matmul)
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many ops on tiny tensors: one intra-op thread (see
    ``test_torch_sparse.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(tree):
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _dropless(cfg):
    """The capacity factor at which a group's capacity is its length."""
    return dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts
                               / cfg.top_k)


def _dropped(monkeypatch):
    """A list that collects each routing's count of dropped live
    assignments, by wrapping ``ops.moe_route``."""
    log = []
    route = ops.moe_route

    def recording(logits, *, group, top_k, capacity, q_lens=None, **kw):
        r = route(logits, group=group, top_k=top_k, capacity=capacity,
                  q_lens=q_lens, **kw)
        live = logits.shape[0] if q_lens is None else int(q_lens.sum())
        log.append(live * top_k - int(r.counts.sum()))
        return r
    monkeypatch.setattr(ops, "moe_route", recording)
    return log


# -- configs and quantization -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_reference(arch):
    """Every field of the port's config equals the reference's of that
    name, full size and smoke (dtype: bf16 / f32 in both)."""
    for full in (True, False):
        want = (jax_config if full else jax_smoke_config)(arch)
        got = (get_config if full else get_smoke_config)(arch)
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.is_moe and got.family == "moe"


def _assert_quant_equal(jq, tq):
    assert isinstance(tq, QuantizedTensor)
    assert tq.group_size == jq.group_size and tq.shape == tuple(jq.shape)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scales.float().numpy(),
                                  np.asarray(jq.scales).astype(np.float32))


def test_expert_groups_match_reference_at_granite_widths():
    """Under ``moe`` a (1536, 512) gate and a (512, 1536) down take 32-row
    groups (the reference's 16-way rule), stacked over 2 layers x 2
    experts: group size, packed bytes and scales bitwise; outside ``moe``
    the same matrix keeps 128."""
    rng = np.random.default_rng(0)
    gate = rng.normal(size=(2, 2, 1536, 512)).astype(np.float32) / 40
    down = rng.normal(size=(2, 2, 512, 1536)).astype(np.float32) / 20
    tree = {"moe": {"gate": gate, "down": down, "router": gate[0, 0, :, :8]},
            "mlp": {"gate": gate[0, 0]}}
    jq = jax_quantize(jax.tree.map(jnp.asarray, tree), "dense")
    tq = quantize_model(jax.tree.map(_t, tree), "dense")
    for name in ("gate", "down"):
        assert tq["moe"][name].group_size == 32
        assert tq["moe"][name].packed.shape[:2] == (2, 2)
        _assert_quant_equal(jq["moe"][name], tq["moe"][name])
    assert tq["mlp"]["gate"].group_size == 128
    _assert_quant_equal(jq["mlp"]["gate"], tq["mlp"]["gate"])
    assert torch.equal(tq["moe"]["router"], _t(tree["moe"]["router"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_trees_quantize_as_reference(arch):
    """``quantize_model`` of the reference's smoke tree (through numpy) is
    the reference's: granite's d_ff 64 keeps down 16-bit (64 < a group),
    mixtral's experts take 128-row groups; the router stays f32."""
    jcfg = jax_smoke_config(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    want = _port(jax_quantize(jparams, "dense"))
    got = quantize_model(_port(jparams), "dense")
    for name, leaf in got["blocks"]["moe"].items():
        ref = want["blocks"]["moe"][name]
        assert type(leaf) is type(ref), name
        if isinstance(leaf, QuantizedTensor):
            assert leaf.group_size == ref.group_size
            assert torch.equal(leaf.packed, ref.packed)
            assert torch.equal(leaf.scales, ref.scales)
        else:
            assert torch.equal(leaf, ref) and leaf.dtype == ref.dtype
    kinds = {k: type(v).__name__ for k, v in got["blocks"]["moe"].items()}
    down = "Tensor" if arch.startswith("granite") else "QuantizedTensor"
    assert kinds == {"router": "Tensor", "gate": "QuantizedTensor",
                     "up": "QuantizedTensor", "down": down}
    assert got["blocks"]["moe"]["router"].dtype == torch.float32


def test_sparse_strategies_refuse_experts():
    cfg = get_smoke_config("mixtral-8x22b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="sparse experts"):
        quantize_model(params, "strategy2")


@pytest.mark.parametrize("group", [32, 64, 128])
def test_kernel1_plain_at_expert_groups_matches_reference(group):
    """Kernel 1's plain version at the experts' groups against the
    reference's W4A16 twin; ``fused_variant`` sends such experts to the
    CUDA ``"quant"`` path, whose launch takes them in bf16 only."""
    rng = np.random.default_rng(group)
    w = rng.normal(size=(512, 256)).astype(np.float32) / 20
    x = rng.normal(size=(5, 512)).astype(np.float32)
    from repro.core.quant import quantize as jquantize
    jq = jquantize(jnp.asarray(w), group_size=group)
    tq = quantize(_t(w), group_size=group)
    _assert_quant_equal(jq, tq)
    want = jops.w4a16_matmul(jnp.asarray(x), jq, impl="xla")
    got = w4a16_matmul.w4a16_matmul_torch(_t(x), tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert ffn_fused.fused_variant(tq, tq, tq, "swiglu") == "quant"
    bf16 = torch.zeros(1, dtype=torch.bfloat16)
    assert group in w4a16_matmul.group_sizes(bf16)
    assert w4a16_matmul.group_sizes(bf16.float()) == (128,)
    assert w4a16_matmul.group_sizes(bf16, epilogue=True) == (128,)
    if group != 128:
        with pytest.raises(ValueError, match="row groups"):
            w4a16_matmul.check_quantized(tq, tq.packed.device, "w",
                                         (128,))


# -- capacity, routing, dispatch and combine ----------------------------------

def _cfgs(arch, factor=None):
    jcfg = jax_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=factor)
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    for factor in (1.0, 1.25, 2.0, 4.0, 5.0):
        jcfg, tcfg = _cfgs(arch, factor)
        for s in (1, 2, 7, 8, 16, 64, 333, 4096):
            assert moe.capacity(tcfg, s) == jmoe.capacity(jcfg, s)
    tcfg = get_config(arch)
    assert moe.capacity(_dropless(tcfg), 64) == 64
    assert moe.capacity(tcfg, 1) == tcfg.top_k


def _skewed(rng, b, s, d, e, skew=1.5):
    """x (b, s, d) and a router (d, e) whose expert 0 most tokens prefer,
    so a group overflows its capacity."""
    router = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    u = router[:, 0] / np.linalg.norm(router[:, 0])
    x = rng.normal(size=(b, s, d)).astype(np.float32) + skew * np.sqrt(d) * u
    return x, router


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """Top-k indices equal, weights within 1e-5, and the aux terms'
    loss, against the reference's ``_route``."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    x, router = _skewed(rng, 3, 16, jcfg.d_model, jcfg.n_experts, skew=0.5)
    topw, topi, me, ce = jmoe._route(jcfg, jnp.asarray(router),
                                     jnp.asarray(x))
    logits = ops.dense_matmul(_t(x).reshape(-1, jcfg.d_model), _t(router))
    r = ops.moe_route(logits, group=16, top_k=tcfg.top_k,
                      capacity=moe.capacity(tcfg, 16))
    np.testing.assert_array_equal(r.topi.numpy(),
                                  np.asarray(topi).reshape(-1, tcfg.top_k))
    np.testing.assert_allclose(r.topw.numpy(),
                               np.asarray(topw).reshape(-1, tcfg.top_k),
                               **LAYER_TOL)
    np.testing.assert_allclose(
        float(moe.aux_loss(tcfg, logits, r.topi)),
        float(jmoe._aux_loss(jcfg, me, ce)), **LAYER_TOL)


def test_route_ties_go_to_the_lower_index():
    """Equal router columns give equal probabilities: both packages take
    the lower expert index first, in the same order."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    rng = np.random.default_rng(2)
    router = (rng.normal(size=(jcfg.d_model, 4)) / 10).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    x = rng.normal(size=(1, 8, jcfg.d_model)).astype(np.float32)
    _, topi, _, _ = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    logits = ops.dense_matmul(_t(x[0]), _t(router))
    r = ops.moe_route(logits, group=8, top_k=2, capacity=8)
    want = np.asarray(topi)[0]
    np.testing.assert_array_equal(r.topi.numpy(), want)
    assert all(sorted(row) == list(row) for row in want.tolist())
    assert {tuple(row) for row in want.tolist()} <= {(0, 2), (1, 3)}


def _jax_dispatch_identity(jcfg, x, topi, topw):
    return jmoe._dispatch_compute(jcfg, jnp.asarray(x), topi, topw,
                                  lambda h: h)


@pytest.mark.parametrize("factor", [1.25, "dropless"])
def test_dispatch_and_combine_match_reference(factor):
    """Dispatch and combine alone (an identity expert): each token's
    weighted sum of its kept copies, bitwise-close to the reference's
    capacity buffer, trash row and scatter-add; at 1.25 some assignments
    drop (asserted) and the same ones in both packages."""
    arch = "mixtral-8x22b"
    jcfg, tcfg = _cfgs(arch)
    if factor == "dropless":
        jcfg, tcfg = _dropless(jcfg), _dropless(tcfg)
    else:
        jcfg, tcfg = _cfgs(arch, factor)
    rng = np.random.default_rng(3)
    b, s, d = 2, 32, jcfg.d_model
    x, router = _skewed(rng, b, s, d, jcfg.n_experts)
    topw, topi, _, _ = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    want = np.asarray(_jax_dispatch_identity(jcfg, x, topi, topw))
    x2 = _t(x).reshape(b * s, d)
    r = ops.moe_route(ops.dense_matmul(x2, _t(router)), group=s,
                      top_k=tcfg.top_k, capacity=moe.capacity(tcfg, s))
    np.testing.assert_array_equal(r.topi.numpy(),
                                  np.asarray(topi).reshape(-1, tcfg.top_k))
    kept = int(r.counts.sum())
    dropped = b * s * tcfg.top_k - kept
    assert (dropped > 0) == (factor == 1.25)
    assert int((r.slot < 0).sum()) == dropped
    assert sorted(r.slot[r.slot >= 0].tolist()) == list(range(kept))
    # the rows each expert reads are its kept tokens, in group then flat order
    token = np.repeat(np.arange(b * s), tcfg.top_k).reshape(b * s, -1)
    assert torch.equal(r.rows[r.slot[r.slot >= 0].long()],
                       _t(token)[r.slot >= 0].int())
    y = x2[r.rows.long()]
    got = ops.moe_combine(y, r.slot, r.topw).reshape(b, s, d)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.25, "dropless"])
@pytest.mark.parametrize("strategy", ["none", "dense"])
def test_moe_apply_matches_reference(arch, factor, strategy, monkeypatch):
    """``moe_apply`` (output and aux) against the reference's
    ``_moe_apply_local`` on its own smoke weights (16-bit, or quantized:
    granite's mix of int4 gate/up and 16-bit down, mixtral's all int4)."""
    jcfg, tcfg = _cfgs(arch, None if factor == "dropless" else factor)
    if factor == "dropless":
        jcfg, tcfg = _dropless(jcfg), _dropless(tcfg)
    p = jmoe.moe_init(jax.random.PRNGKey(4), jcfg)
    if strategy == "dense":
        p = jax_quantize({"moe": p}, "dense")["moe"]
    rng = np.random.default_rng(5)
    x, router = _skewed(rng, 2, 32, jcfg.d_model, jcfg.n_experts)
    p = dict(p, router=jnp.asarray(router))
    want, jaux = jmoe._moe_apply_local(jcfg, p, jnp.asarray(x))
    tp = _port(p)
    log = _dropped(monkeypatch)
    got, aux = moe.moe_apply(tcfg, tp, _t(x), with_aux=True)
    assert (log[0] > 0) == (factor == 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LAYER_TOL)


def test_dead_positions_take_no_row():
    """A mixed chunk's positions past ``q_lens`` take no expert row and
    give zeros; the live ones are those of the whole chunk routed."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    tcfg = _dropless(tcfg)
    rng = np.random.default_rng(6)
    p = _port(jax_quantize({"moe": jmoe.moe_init(jax.random.PRNGKey(0),
                                                 jcfg)}, "dense")["moe"])
    x = _t(rng.normal(size=(3, 8, jcfg.d_model)).astype(np.float32))
    q = torch.tensor([8, 3, 0], dtype=torch.int32)
    full, _ = moe.moe_apply(tcfg, p, x)
    part, _ = moe.moe_apply(tcfg, p, x, q_lens=q)
    live = torch.arange(8)[None] < q[:, None].long()
    assert torch.equal(part[live], full[live])
    assert not part[~live].any()
    logits = ops.dense_matmul(x.reshape(24, -1), moe._router(p["router"],
                                                             x.dtype))
    r = ops.moe_route(logits, group=8, top_k=2, capacity=8, q_lens=q)
    assert int(r.counts.sum()) == 11 * 2
    assert bool((r.slot.reshape(3, 8, 2)[~live] == -1).all())


def test_router_cast_is_made_once():
    r = torch.randn(8, 4)
    a = moe._router(r, torch.bfloat16)
    assert a is moe._router(r[:], torch.bfloat16)
    assert torch.equal(a, r.to(torch.bfloat16))
    assert moe._router(r, torch.float32) is r


# -- the fused route and the combine inside the next norm ----------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_route_plain_is_dense_matmul_then_route(arch):
    """``ops.moe_router_route``'s plain version (and
    ``moe_route.moe_router_route_torch``): the logits ``dense_matmul``'s
    and every ``Route`` field ``moe_route``'s on them, with dead positions
    and drops, in both dtypes."""
    jcfg, tcfg = _cfgs(arch, 1.0)
    rng = np.random.default_rng(11)
    b, s, k = 3, 16, tcfg.top_k
    x, router = _skewed(rng, b, s, jcfg.d_model, jcfg.n_experts)
    q = torch.tensor([16, 5, 0], dtype=torch.int32)
    cap = moe.capacity(tcfg, s)
    for dtype in (torch.float32, torch.bfloat16):
        x2 = _t(x).reshape(b * s, -1).to(dtype)
        r = moe._router(_t(router), dtype)
        want_logits = ops.dense_matmul(x2, r)
        want = ops.moe_route(want_logits, group=s, top_k=k, capacity=cap,
                             q_lens=q)
        assert int(want.counts.sum()) < (16 + 5) * k      # some dropped
        got = [ops.moe_router_route(x2, r, group=s, top_k=k, capacity=cap,
                                    q_lens=q),
               moe_route.moe_router_route_torch(x2, r, s, k, cap, q)]
        for logits, route in got:
            assert torch.equal(logits, want_logits)
            for f in dataclasses.fields(route):
                a, w = getattr(route, f.name), getattr(want, f.name)
                assert (torch.equal(a, w) if isinstance(a, torch.Tensor)
                        else a == w), f.name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keep_sum", [True, False])
def test_combine_add_rmsnorm_plain_is_the_chain(dtype, keep_sum):
    """``ops.combine_add_rmsnorm``'s plain version bitwise ``moe_combine``
    then ``add_rmsnorm`` (the chain it replaces) on a 4 x 8 chunk's
    ``(B, S, k)`` route with drops and dead tokens; a dead token's sum is
    its residual."""
    rng = np.random.default_rng(12)
    b, s, e, k, d = 4, 8, 8, 2, 64
    logits = _t(rng.normal(size=(b * s, e))).to(dtype)
    logits[:, 0] += 2.0
    q = torch.tensor([8, 3, 0, 6], dtype=torch.int32)
    r = moe_route.moe_route_torch(logits, s, k, 4, q)
    assert int(r.counts.sum()) < 17 * k and bool((r.slot < 0).any())
    y = _t(rng.normal(size=(b * s * k, d))).to(dtype)
    x = _t(rng.normal(size=(b, s, d))).to(dtype)
    gamma = _t(rng.normal(size=d)).to(dtype)
    got_s, got_n = ops.combine_add_rmsnorm(
        x, y, r.slot.reshape(b, s, k), r.topw.reshape(b, s, k), gamma,
        keep_sum=keep_sum)
    m = ops.moe_combine(y, r.slot, r.topw).reshape(b, s, d)
    want_s, want_n = ops.add_rmsnorm(x, m, gamma, keep_sum=keep_sum)
    assert got_n.dtype == dtype and torch.equal(got_n, want_n)
    if keep_sum:
        assert torch.equal(got_s, want_s)
        dead = torch.arange(s)[None] >= q[:, None].long()
        assert torch.equal(got_s[dead], x[dead])
    else:
        assert got_s is None and want_s is None


@pytest.mark.parametrize("arch", ARCHS)
def test_walk_with_the_combine_in_the_norm_equals_the_former_walk(
        arch, monkeypatch):
    """The layer walk that hands each MoE layer's ``Experts`` to the next
    norm (``combine_add_rmsnorm``: L a call, the last into ``ln_f``, on the
    last live positions' slots in a mixed step) gives bitwise the logits,
    aux and cache of the former walk (``moe_apply``'s combined output into
    ``add_rmsnorm``), for ``forward``, a mixed and a decode step."""
    _, _, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(13)
    toks = _t(rng.integers(0, tcfg.vocab_size, (2, 8))).long()
    q_lens = np.asarray([8, 3], np.int32)
    dec = _t(rng.integers(0, tcfg.vocab_size, (2, 1))).long()
    fused = []
    combine_norm = ops.combine_add_rmsnorm

    def counted(*a, **kw):
        fused.append(a[0].shape)
        return combine_norm(*a, **kw)
    monkeypatch.setattr(ops, "combine_add_rmsnorm", counted)

    def run():
        logits, aux = api.forward(tcfg, tparams, {"tokens": toks})
        cache = api.init_cache(tcfg, 2, 32, "cpu")
        mixed, cache = api.mixed_step(tcfg, tparams, cache, toks,
                                      np.zeros(2, np.int32), q_lens)
        step, cache = api.decode_step(tcfg, tparams, cache, dec, q_lens + 1)
        return [logits, aux, mixed, step] + [cache[n] for n in sorted(cache)]
    new = run()
    L = tcfg.n_layers
    assert len(fused) == 3 * L and fused[2 * L - 1][:2] == (2, 1)
    experts = moe.moe_experts

    def combined(*a, **kw):
        e, aux = experts(*a, **kw)
        return e.combined(), aux
    monkeypatch.setattr(moe, "moe_experts", combined)
    old = run()
    assert len(fused) == 3 * L
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# -- the model ----------------------------------------------------------------

_MODELS = {}


def _models(arch, strategy="dense", dropless=True):
    key = (arch, strategy, dropless)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        if dropless:
            jcfg, tcfg = _dropless(jcfg), _dropless(tcfg)
        jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
        if strategy != "none":
            jparams = jax_quantize(jparams, strategy)
        _MODELS[key] = (jcfg, jparams, tcfg, _port(jparams))
    return _MODELS[key]


def _assert_cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in tcache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache[name]),
                                   **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True])
def test_forward_and_prefill_match_reference(arch, dropless):
    """``forward`` logits and summed aux, ``prefill`` logits and cache."""
    jcfg, jparams, tcfg, tparams = _models(arch, dropless=dropless)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    jl, jaux = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, taux = api.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MODEL_TOL)
    assert float(taux) > 0
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              32)
    tl, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()}, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True])
def test_steps_match_reference(arch, dropless):
    """W = 8 mixed steps (idle and ragged rows), then decode steps; for
    mixtral the rows run past its 64-token window in a 64-token cache (a
    rolling buffer).  Logits within 1e-4 (live rows) and every cache leaf,
    against the reference."""
    jcfg, jparams, tcfg, tparams = _models(arch, dropless=dropless)
    rng = np.random.default_rng(8)
    b, c, max_len = 2, 8, 64
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    lengths = np.zeros(b, np.int32)
    chunks = [[8, 5], [3, 8], [0, 2], [8, 8]] + [[8, 8]] * (
        5 if jcfg.window else 0)
    for q_lens in chunks:
        q_lens = np.asarray(q_lens, np.int32)
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache,
                                     jnp.asarray(toks), jnp.asarray(lengths),
                                     jnp.asarray(q_lens))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache, _t(toks).long(),
                                    lengths, q_lens)
        live = q_lens > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **MODEL_TOL)
        lengths = lengths + q_lens
    _assert_cache_close(tcache, jcache)
    n_decode = 8 if jcfg.window else 4
    for _ in range(n_decode):
        toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        lengths = lengths + 1
        jl, jcache = japi.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(toks), jnp.asarray(lengths))
        tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(toks).long(),
                                     lengths)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert lengths.max() > (jcfg.window or 0)
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_equals_sequential_at_the_dropless_factor(arch):
    """Nothing drops, so a 13-token prompt in 8-token chunks gives the
    logits of 13 decode steps (1e-5: the CPU's plain matmuls are not
    batch-invariant; the card holds it bitwise)."""
    _, _, tcfg, tparams = _models(arch)
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab_size, 13)
    seq = api.init_cache(tcfg, 1, 32, "cpu")
    for t, tok in enumerate(prompt.tolist()):
        sl, seq = api.decode_step(tcfg, tparams, seq, torch.tensor([[tok]]),
                                  [t + 1])
    mix = api.init_cache(tcfg, 1, 32, "cpu")
    for o in (0, 8):
        ql = min(8, 13 - o)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[o:o + ql]
        ml, mix = api.mixed_step(tcfg, tparams, mix, _t(chunk[None]), [o],
                                 [ql])
    np.testing.assert_allclose(ml.numpy(), sl.numpy(), **LAYER_TOL)


def _work(vocab, n=6):
    rng = np.random.default_rng(10)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20))).astype(
        np.int32), int(rng.integers(2, 8))) for i in range(n)]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_streams_equal_jax_engine_and_oracle(layout):
    """granite-smoke at the dropless factor: the port's engine, the JAX
    engine and ``reference_decode`` give the same streams, on a slot cache
    and a paged pool."""
    jcfg, jparams, tcfg, tparams = _models("granite-moe-3b-a800m")
    if layout == "paged":
        kv = dict(kv_layout="paged", kv_block_size=8, kv_pool_blocks=12)
        jcfg, tcfg = (dataclasses.replace(c, **kv) for c in (jcfg, tcfg))
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    work = _work(jcfg.vocab_size)
    for rid, prompt, n in work:
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.output for r in jengine.run()}
    done = engine.run()
    assert {r.rid: r.output for r in done} == want and len(want) == len(work)
    for r in done[:3]:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu")


def test_launcher_serves_granite_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                "--requests", "2", "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-smoke" in out and "'completed': 2" in out
    with pytest.raises(SystemExit, match="strategy none or dense"):
        serve.main(["--device", "cpu", "--arch", "mixtral-8x22b",
                    "--strategy", "strategy2"])


# -- the card's dispatch ------------------------------------------------------

def test_card_dispatch_reaches_the_moe_kernels(monkeypatch):
    """On the card (``ops._resolve`` patched to "cuda") one MoE layer is
    ``moe_route`` with the router's product inside it (the router cast
    once to x's dtype, the group's capacity and the live positions), the
    grouped gate/up and down kernels on the W4A16 experts, and the next
    norm combining their rows as it adds them (``combine_add_rmsnorm``);
    no router ``dense_matmul``, no ``moe_combine``, no plain version or
    oracle runs."""
    from repro_torch.models import layers
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    p = _port(jax_quantize({"moe": jmoe.moe_init(jax.random.PRNGKey(0),
                                                 jcfg)}, "dense")["moe"])
    calls = []
    b, s, d, k = 2, 8, jcfg.d_model, tcfg.top_k
    route = moe_route.Route(
        torch.ones(b * s, k), torch.zeros(b * s, k, dtype=torch.int32),
        torch.zeros(b * s, k, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        torch.zeros(b * s * k, dtype=torch.int32), 16)
    y = torch.zeros(b * s * k, d)

    def router_route(x, router, group, top_k, capacity, q_lens):
        calls.append(("moe_route", router.dtype, router.shape, group, top_k,
                      capacity, q_lens))
        return torch.zeros(x.shape[0], router.shape[1]), route

    def gate_up(x, r, gate, up, activation):
        calls.append(("moe_gate_up_w4a16", r is route, gate.group_size,
                      activation))
        return torch.zeros(b * s * k, up.shape[1])

    def down(hidden, r, dw):
        calls.append(("moe_down_w4a16", r is route, dw.group_size))
        return y

    def combine_norm(x, yy, slot, topw, gamma, eps, keep_sum):
        calls.append(("combine_add_rmsnorm", yy is y, tuple(slot.shape),
                      torch.equal(slot.reshape(-1, k), route.slot),
                      keep_sum))
        return x, torch.zeros_like(x)

    def refuse(*a, **kw):
        raise AssertionError("a plain version, the oracle or an unfused "
                             "kernel ran on the card's path")
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "moe_router_route_cuda", router_route)
    monkeypatch.setattr(moe_experts, "moe_gate_up_cuda", gate_up)
    monkeypatch.setattr(moe_experts, "moe_down_cuda", down)
    monkeypatch.setattr(ops, "combine_add_rmsnorm_cuda", combine_norm)
    for name in ("moe_route_torch", "moe_ffn_torch", "moe_combine_torch",
                 "combine_add_rmsnorm_torch", "moe_route_cuda",
                 "moe_combine_cuda", "dense_matmul_cuda", "add_rmsnorm_cuda"):
        monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(ops._ref, "ffn_ref", refuse)
    x = torch.zeros(b, s, d)
    q = torch.tensor([8, 3], dtype=torch.int32)
    experts, aux = moe.moe_experts(tcfg, p, x, q_lens=q)
    _, n = layers.add_norm(tcfg, {"gamma": torch.ones(d)}, x, experts)
    assert n.shape == x.shape and aux is None
    assert [c[0] for c in calls] == ["moe_route", "moe_gate_up_w4a16",
                                     "moe_down_w4a16", "combine_add_rmsnorm"]
    assert calls[0][1:6] == (torch.float32, (d, 4), s, k,
                             moe.capacity(tcfg, s))
    assert calls[0][6] is q
    assert calls[1][1:] == (True, 128, "swiglu")
    assert calls[2][1:] == (True, 128)
    assert calls[3][1:] == (True, (b, s, k), True, True)


def test_card_refuses_experts_the_grouped_tile_does_not_take():
    """16-bit experts, and granite-smoke's int4 gate/up with a 16-bit down,
    have no CUDA path: ``check_experts`` raises instead of falling back."""
    _, _, _, tparams = _models("granite-moe-3b-a800m")
    blocks = tparams["blocks"]["moe"]
    moe_experts.check_experts(blocks["gate"][0], 4, torch.device("cpu"),
                              "gate")
    with pytest.raises(NotImplementedError, match="W4A16 experts"):
        moe_experts.check_experts(blocks["down"][0], 4, torch.device("cpu"),
                                  "down")
    with pytest.raises(ValueError, match="group"):
        bad = dataclasses.replace(blocks["gate"][0], group_size=16)
        moe_experts.check_experts(bad, 4, torch.device("cpu"), "gate")


def test_wrappers_pass_every_c_parameter():
    """Each ``_build.function(lib, symbol, argtypes)`` call of the kernel
    wrappers names a C entry point of ``csrc/<lib>.cu`` with as many
    parameters as its argtypes, pointers where the C side takes pointers
    (the card would read a shifted argument list; the CPU cannot launch)."""
    import ctypes
    import importlib
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    kdir = Path(_build.__file__).parent
    calls = 0
    for py in sorted(kdir.glob("*.py")):
        src = py.read_text()
        mod = importlib.import_module(f"repro_torch.kernels.{py.stem}")
        for lib, sym, arg in re.findall(
                r'_build\.function\(\s*(\w+|"\w+"),\s*"(\w+)",\s*(\w+)\)',
                src):
            lib = lib.strip('"') if lib.startswith('"') else getattr(mod,
                                                                   lib)
            cu = (kdir / "csrc" / f"{lib}.cu").read_text()
            m = re.search(r'extern "C" int ' + sym + r'\(([^)]*)\)', cu)
            assert m, (lib, sym)
            params = [p.strip() for p in m.group(1).split(",")]
            types = getattr(mod, arg)
            assert len(params) == len(types), (sym, params, types)
            for p, t in zip(params, types):
                pointer = t is ctypes.c_void_p or issubclass(
                    t, ctypes._Pointer)
                assert ("*" in p) == pointer, (sym, p, t)
            calls += 1
    assert calls >= 20
