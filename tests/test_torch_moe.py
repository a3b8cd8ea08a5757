"""The port's MoE MLP (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same numpy inputs and the reference's own
weights: both dispatch modes, float32 and bfloat16, the E/k of the Mixtral
and Grok SMOKE configs and of ``tests/test_models.py``'s MoE cases, the
aux losses, and a router built to tie at the k-th place.

Tolerances: outputs within 1e-5 x max(1, max |ref|) in float32 (products
summed in another order) and 2^-7 x max(1, max |ref|) in bfloat16 (two
units of bf16 rounding); aux losses within 1e-5 x max(1, |ref|) (float32
arithmetic on the same rounded logits).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JaxConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
AUX_TOL = 1e-5

_SMALL = dict(family="moe", num_layers=1, num_heads=2, num_kv_heads=1,
              vocab_size=64)
# name -> (E, k, D, F): the SMOKE configs, test_models.py's two MoE
# cases, and Mixtral's full E/k at a small width
SHAPES = {
    "mixtral_smoke": "mixtral_8x22b",
    "grok_smoke": "grok_1_314b",
    "test_models_aux": (4, 2, 32, 64),
    "test_models_gather": (3, 2, 16, 32),
    "e8_k2": (8, 2, 64, 96),
}


def _configs(name, dtype):
    spec = SHAPES[name]
    if isinstance(spec, str):
        return (jax_get_smoke(spec).with_(dtype=dtype),
                get_smoke(spec).with_(dtype=dtype))
    E, k, D, Fd = spec
    kw = dict(name=name, d_model=D, d_ff=Fd, num_experts=E,
              experts_per_token=k, dtype=dtype, **_SMALL)
    return JaxConfig(**kw), ModelConfig(**kw)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _params(cfg_j, seed=0):
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j, cfg_j.jnp_dtype)
    pt = jax.tree_util.tree_map(_to_torch, pj)
    return pj, pt


def _x(D, dtype, B=2, T=12, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)
    return jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.fixture
def dispatch():
    """Set both packages' dispatch mode; restore 'ragged' after."""
    def set_both(mode):
        jmoe.set_dispatch(mode)
        tmoe.set_dispatch(mode)
    yield set_both
    set_both("ragged")


@pytest.mark.parametrize("mode", ["ragged", "capacity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_apply_moe_matches_reference(dispatch, name, dtype, mode):
    cfg_j, cfg_t = _configs(name, dtype)
    dispatch(mode)
    pj, pt = _params(cfg_j)
    xj, xt = _x(cfg_t.d_model, dtype)
    yj, aux_j = jmoe.apply_moe(pj, cfg_j, xj, return_aux=True)
    yt, aux_t = tmoe.apply_moe(pt, cfg_t, xt, return_aux=True)
    assert yt.shape == xt.shape and yt.dtype == xt.dtype
    _close(yt, yj, TOL[dtype])
    assert set(aux_t) == set(aux_j)
    for key, val in aux_j.items():
        want = float(val)
        assert abs(float(aux_t[key]) - want) <= AUX_TOL * max(1.0, abs(want))
    # without aux: the same output, bit for bit
    assert torch.equal(tmoe.apply_moe(pt, cfg_t, xt), yt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tight_capacity_drops_as_the_reference(dtype):
    cfg_j, cfg_t = _configs("test_models_aux", dtype)
    pj, pt = _params(cfg_j, seed=2)
    xj, xt = _x(cfg_t.d_model, dtype, B=4, T=16, seed=3)
    D = cfg_t.d_model
    yj, aux_j = jmoe._moe_capacity_math(pj, cfg_j, xj.reshape(-1, D),
                                        capacity_factor=0.5)
    yt, aux_t = tmoe._moe_capacity_math(pt, cfg_t, xt.reshape(-1, D),
                                        capacity_factor=0.5)
    drop = float(aux_j["drop_fraction"])
    assert 0.0 < drop < 1.0
    assert float(aux_t["drop_fraction"]) == pytest.approx(drop, abs=1e-7)
    _close(yt, yj, TOL[dtype])


def _tied_router(cfg, dtype):
    """Router columns u * (2, 1, -1, 1): logits (2s, s, -s, s) with
    s = x . u, so experts 1 and 3 tie exactly; at k = 2 the tie is at the
    k-th place (s > 0: expert 0 first; s < 0: expert 2 first)."""
    rng = np.random.default_rng(5)
    u = rng.standard_normal(cfg.d_model).astype(np.float32) / np.sqrt(
        cfg.d_model)
    w = np.stack([2 * u, u, -u, u], axis=1)
    return jnp.asarray(w, dtype=dtype), torch.from_numpy(w).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_choose_what_lax_top_k_chooses(dtype):
    cfg_j, cfg_t = _configs("test_models_aux", dtype)
    pj, pt = _params(cfg_j, seed=4)
    wj, wt = _tied_router(cfg_t, dtype)
    pj["router"]["w"], pt["router"]["w"] = wj, wt
    xj, xt = _x(cfg_t.d_model, dtype, B=1, T=16, seed=6)
    D = cfg_t.d_model
    logits = (xj.reshape(-1, D) @ wj).astype(jnp.float32)
    _, topi_j = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    _, _, _, topi_t = tmoe._route(pt, cfg_t, xt.reshape(-1, D))
    topi_j = np.asarray(topi_j)
    # every row ties experts 1 and 3, and the reference keeps expert 1
    assert (topi_j == 1).any(axis=1).all() and not (topi_j == 3).any()
    np.testing.assert_array_equal(topi_t.numpy(), topi_j)
    _close(tmoe.apply_moe(pt, cfg_t, xt), jmoe.apply_moe(pj, cfg_j, xj),
           TOL[dtype])


def test_load_balance_loss_at_least_one():
    """As test_models.py's MoE case: the Switch loss is >= 1 (Cauchy-
    Schwarz), and the output keeps the input's shape."""
    cfg_j, cfg_t = _configs("test_models_aux", "float32")
    _, pt = _params(cfg_j, seed=9)
    _, xt = _x(cfg_t.d_model, "float32", B=2, T=8, seed=10)
    y, aux = tmoe.apply_moe(pt, cfg_t, xt, return_aux=True)
    assert float(aux["load_balance_loss"]) >= 1.0 - 1e-3
    assert y.shape == xt.shape


def test_moe_init_scales_and_shapes():
    cfg = get_smoke("mixtral_8x22b")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tmoe.moe_init(gen, cfg, torch.float32, "cpu")
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert p["router"]["w"].shape == (D, E)
    assert p["wi"].shape == p["wg"].shape == (E, D, Fd)
    assert p["wo"].shape == (E, Fd, D)
    for leaf, fan_in in ((p["wi"], D), (p["wg"], D), (p["wo"], Fd)):
        assert float(leaf.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "grok_1_314b"])
def test_configs_and_param_counts_equal_the_reference(arch, full):
    """The ported configs equal the reference's field for field, and
    count the same total and active (routed-expert) parameters."""
    get_j, get_t = ((jax_get_config, get_config) if full
                    else (jax_get_smoke, get_smoke))
    cfg_j, cfg_t = get_j(arch), get_t(arch)
    assert repr(cfg_t) == repr(cfg_j)
    assert cfg_t.param_count() == cfg_j.param_count()
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    assert cfg_t.active_param_count() < cfg_t.param_count()
