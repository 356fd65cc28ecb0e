"""Port parity, the training stack: ``repro_torch.optim.adamw``, the train
steps of ``repro_torch.launch.steps`` (LM, GNN and recsys, through
``convert.train_state_from_numpy``), the gradients the steps take (remat,
chunked attention, the flash entry under grad, the GNN gathers and
extrema), ``repro_torch.ckpt``, ``repro_torch.launch.train``,
``repro_torch.dist.compression`` and ``repro_torch.examples.train_lm``,
against the JAX package on the CPU.

``repro.launch.train.train`` itself fails on this JAX version (it enters a
mesh context whose ``with_sharding_constraint`` jax 0.9 refuses), so
``train()`` is held to the claims of the reference's tests
(``tests/test_train_loop.py``): the loss falls over 16 steps, a crash and
a restart resume bit for bit, the other families stay finite.  The
checkpoint and ``compressed_psum`` are held to the reference's functions
themselves: a round trip gives the same values as the reference's, the
same faulty targets raise the same errors, and on one rank the compressed
sum equals the reference's bit for bit.

The JAX side is the reference's own functions: ``adamw_update``, and
``build_bundle(...).step_fn`` under ``jax.jit`` outside a mesh context.
Both packages start from the JAX package's state and take the JAX
package's batches (``make_batch`` / ``graph_batch``).  The port runs
backend ``torch`` on the CPU.

Tolerances, each set from the readings on the CPU and each failed by a control:

  * AdamW, 5 updates: float32 leaves (params, ``mu``, ``nu``) and ``gnorm``
    within ``rtol=1e-6`` (measured: equal or one float32 ulp); bfloat16
    leaves within one bfloat16 ulp.  Control: ``lr`` doubled.
  * Train steps, 3 each, loss and ``gnorm`` at every step and every
    parameter after step 3, its difference measured against its own
    update (``||p_port - p_jax|| / ||p_jax - p_0||``):
      - LM float32: loss ``rtol=1e-5`` (measured 1.6e-6), gnorm ``5e-4``
        (7.9e-5), parameters ``0.4`` (0.18);
      - LM bfloat16, the published dtype: loss ``5e-3`` (8.6e-4), gnorm
        ``2e-2`` (3.2e-3), parameters ``0.5`` (0.28);
      - GNN and recsys (float32): loss and gnorm ``1e-5`` (1.5e-6),
        parameters ``2e-3`` (2.6e-4).
    An LM parameter's share is large because Adam moves every element by
    about ``lr`` whatever its gradient's size: an element whose gradient is
    near zero takes either sign in either package.  Control: the port's
    step with ``lr`` doubled, whose update differs from the reference's by
    its whole size.
"""

from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.ckpt import restore_pytree as jax_restore_pytree
from repro.ckpt import save_pytree as jax_save_pytree
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data.synthetic import graph_batch as jax_graph_batch
from repro.data.synthetic import make_batch as jax_make_batch
from repro.dist.compression import compressed_psum as jax_compressed_psum
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_bundle as jax_build_bundle
from repro.models.gnn.message_passing import segment_reduce as jax_segment_reduce
from repro.models.transformer import lm_loss_and_stats as jax_lm_loss_and_stats
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
import repro_torch.launch.steps as steps
import repro_torch.models.attention as A
from repro_torch.ckpt import Checkpointer, ckpt_path, latest_step, restore_pytree, save_pytree
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.dist import compressed_psum, partition_mesh, run_ranks
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.segment_sum import gather_rows
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import train
from repro_torch.models.gnn import sort_edges
import repro_torch.models.gnn.message_passing as MP
from repro_torch.models.gnn.message_passing import segment_reduce
from repro_torch.models.transformer import lm_loss_and_stats
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

ADAM_RTOL = 1e-6
LM_F32 = dict(loss=1e-5, gnorm=5e-4, params=0.4)
LM_BF16 = dict(loss=5e-3, gnorm=2e-2, params=0.5)
F32 = dict(loss=1e-5, gnorm=1e-5, params=2e-3)


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bfloat16 ulps between two bfloat16 tensors."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return (key(a) - key(b)).abs()


# -- AdamW ------------------------------------------------------------------------------


LEAVES = {"w2": ((6, 5), "float32"), "b1": ((7,), "float32"),
          "wb": ((4, 6), "bfloat16"), "nb": ((9,), "bfloat16")}


class _Tree(nn.Module):
    def __init__(self, values: dict):
        super().__init__()
        for k, v in values.items():
            setattr(self, k, nn.Parameter(v.clone()))


def _adam_inputs(seed: int, grad_scale: float):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(shape).astype(np.float32) for k, (shape, _) in LEAVES.items()}
    grads = [{k: (rng.standard_normal(shape) * grad_scale).astype(np.float32)
              for k, (shape, _) in LEAVES.items()} for _ in range(5)]
    return params, grads


def _run_jax_adam(params, grads, moment):
    cfg = JaxAdamWConfig(moment_dtype=jnp.bfloat16 if moment == "bfloat16" else jnp.float32)
    p = {k: jnp.asarray(v, LEAVES[k][1]) for k, v in params.items()}
    state = jax_adamw_init(p, cfg)
    gnorms = []
    for g in grads:
        g = {k: jnp.asarray(v, LEAVES[k][1]) for k, v in g.items()}
        p, state, gnorm = jax_adamw_update(p, g, state, cfg)
        gnorms.append(float(gnorm))
    return p, state, gnorms


def _run_port_adam(params, grads, moment, lr_scale=1.0):
    cfg = AdamWConfig(lr=3e-4 * lr_scale,
                      moment_dtype=torch.bfloat16 if moment == "bfloat16" else torch.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    model = _Tree({k: T(v).to(dt[LEAVES[k][1]]) for k, v in params.items()})
    state = adamw_init(model, cfg)
    gnorms = []
    for g in grads:
        gnorm = adamw_update(model, {k: T(v).to(dt[LEAVES[k][1]]) for k, v in g.items()},
                             state, cfg)
        gnorms.append(float(gnorm))
    return dict(model.named_parameters()), state, gnorms


def _check_adam(jax_out, port_out):
    (jp, jstate, jg), (tp, tstate, tg) = jax_out, port_out
    np.testing.assert_allclose(tg, jg, rtol=ADAM_RTOL)
    assert int(tstate["count"]) == int(jstate["count"]) == 5
    pairs = [(tp[k].detach(), jp[k]) for k in LEAVES]
    pairs += [(tstate[m][k], jstate[m][k]) for m in ("mu", "nu") for k in LEAVES]
    for t, j in pairs:
        ref = torch.as_tensor(np.asarray(j.astype(jnp.float32)))
        if t.dtype == torch.bfloat16:
            assert int(bf16_ulps(t, ref.to(torch.bfloat16)).max()) <= 1
        else:
            np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=ADAM_RTOL, atol=1e-30)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no-clip", "clip-binds"])
def test_adamw_matches_jax(moment, grad_scale):
    params, grads = _adam_inputs(0, grad_scale)
    jax_out = _run_jax_adam(params, grads, moment)
    clipped = jax_out[2][0] > 1.0
    assert clipped == (grad_scale > 1)
    _check_adam(jax_out, _run_port_adam(params, grads, moment))
    with pytest.raises(AssertionError):  # the control: lr doubled
        _check_adam(jax_out, _run_port_adam(params, grads, moment, lr_scale=2.0))


def test_adamw_leaves_a_gradless_parameter_where_it_is():
    """MoE's ``router_bias`` gets no gradient: the zero-gradient update of
    the reference moves neither it nor its moments."""
    model = _Tree({"w": torch.ones(3, 3), "bias": torch.full((4,), 0.5)})
    model.bias.requires_grad_(False)
    state = adamw_init(model, AdamWConfig())
    gnorm = adamw_update(model, {"w": torch.ones(3, 3), "bias": None}, state, AdamWConfig())
    assert float(gnorm) == 3.0
    assert torch.equal(model.bias, torch.full((4,), 0.5))
    assert not state["mu"]["bias"].any() and not state["nu"]["bias"].any()
    assert not torch.equal(model.w, torch.ones(3, 3))


def test_adamw_is_not_torch_adamw():
    """``torch.optim.AdamW`` decays every tensor and clips nowhere: it fails
    the parity that ``adamw_update`` holds."""
    params, grads = _adam_inputs(1, 10.0)
    jax_out = _run_jax_adam(params, grads, "float32")
    model = _Tree({k: T(v) for k, v in params.items()})
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1)
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = T(g[k])
        opt.step()
    with pytest.raises(AssertionError):
        for k in LEAVES:
            np.testing.assert_allclose(getattr(model, k).detach().float().numpy(),
                                       np.asarray(jax_out[0][k].astype(jnp.float32)),
                                       rtol=ADAM_RTOL)


# -- train steps --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh()


def _jax_batches(jb, family: str, n: int = 3) -> list:
    out = []
    for i in range(n):
        if family == "gnn":
            inputs = jb.abstract_inputs
            n_nodes = (inputs.get("x") or inputs["species"]).shape[0]
            out.append(jax_graph_batch(inputs, seed=0, step=i, n_nodes=n_nodes))
        else:
            out.append(jax_make_batch(jb.abstract_inputs, seed=0, step=i,
                                      bounds=jb.input_bounds))
    return out


def _params(state) -> dict:
    return {n: p.detach().clone() for n, p in state["params"].named_parameters()}


def _run_steps(arch: str, shape: str, host_mesh, f32: bool):
    """The JAX bundle's three steps, and the port's from the same state on
    the same batches: ``(jax metrics, port state and metrics, the state the
    port started from, the JAX state after step 3 in the port's layout)``."""
    family = JAX_ARCHS[arch].family
    jb = jax_build_bundle(arch, shape, host_mesh, reduced=True)
    tb = steps.build_bundle(arch, shape, reduced=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in tb.abstract_inputs.items()} == {
        k: tuple(v.shape) for k, v in jb.abstract_inputs.items()}
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    if f32:
        js = jax.tree.map(
            lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, js)
    cfg = reduced_config(ARCHS[arch])
    np_state = jax.tree.map(np.asarray, js)
    batches = _jax_batches(jb, family)
    step = jax.jit(jb.step_fn)
    jm = []
    for b in batches:
        js, m = step(js, b)
        jm.append((float(m["loss"]), float(m["gnorm"])))
    j_end = train_state_from_numpy(family, jax.tree.map(np.asarray, js), cfg, device="cpu")
    return tb, np_state, family, cfg, batches, jm, j_end


def _port_steps(tb, np_state, family, cfg, batches, lr_scale=1.0):
    state = train_state_from_numpy(family, np_state, cfg, device="cpu")
    start = _params(state)
    step = tb.step_fn
    if lr_scale != 1.0:
        # the control: the same step with lr scaled, by the module's own config
        orig = steps.adamw_update
        step = _scaled_step(tb, orig, lr_scale)
    tm = []
    for b in batches:
        state, m = step(state, {k: T(v) for k, v in b.items()})
        tm.append((float(m["loss"]), float(m["gnorm"])))
    return state, start, tm


def _scaled_step(tb, orig, lr_scale):
    def step(state, batch):
        steps.adamw_update = lambda model, grads, st, cfg: orig(
            model, grads, st, dataclasses.replace(cfg, lr=cfg.lr * lr_scale))
        try:
            return tb.step_fn(state, batch)
        finally:
            steps.adamw_update = orig

    return step


def _check_steps(jm, tm, j_end, t_state, start, tol):
    for (jl, jg), (tl, tg) in zip(jm, tm):
        np.testing.assert_allclose(tl, jl, rtol=tol["loss"])
        np.testing.assert_allclose(tg, jg, rtol=tol["gnorm"])
    ref = dict(j_end["params"].named_parameters())
    for name, p in t_state["params"].named_parameters():
        r = ref[name].detach().float()
        moved = (r - start[name].float()).norm()
        diff = (p.detach().float() - r).norm()
        if moved == 0:
            assert diff == 0, name
            continue
        assert float(diff / moved) <= tol["params"], (name, float(diff / moved))
    for m in ("mu", "nu"):
        assert set(t_state["opt"][m]) == set(ref)
    assert int(t_state["opt"]["count"]) == int(j_end["opt"]["count"]) == len(jm)


TRAIN_CASES = [
    ("tinyllama-1.1b", "train_4k", True, LM_F32),
    ("tinyllama-1.1b", "train_4k", False, LM_BF16),
    ("mixtral-8x22b", "train_4k", True, LM_F32),
    ("mixtral-8x22b", "train_4k", False, LM_BF16),
    ("deepseek-v3-671b", "train_4k", False, LM_BF16),
    ("pna", "full_graph_sm", False, F32),
    ("meshgraphnet", "minibatch_lg", False, F32),
    ("mace", "molecule", False, F32),
    ("dimenet", "molecule", False, F32),
    ("deepfm", "train_batch", False, F32),
]


@pytest.mark.parametrize(
    "arch, shape, f32, tol", TRAIN_CASES,
    ids=[f"{a}-{'f32' if f else 'native'}" for a, _, f, _ in TRAIN_CASES])
def test_train_steps_match_jax(arch, shape, f32, tol, host_mesh):
    tb, np_state, family, cfg, batches, jm, j_end = _run_steps(arch, shape, host_mesh, f32)
    t_state, start, tm = _port_steps(tb, np_state, family, cfg, batches)
    _check_steps(jm, tm, j_end, t_state, start, tol)
    if arch in ("tinyllama-1.1b", "pna"):
        ctrl_state, _, ctrl_m = _port_steps(tb, np_state, family, cfg, batches, lr_scale=2.0)
        with pytest.raises(AssertionError):
            _check_steps(jm, ctrl_m, j_end, ctrl_state, start, tol)


def test_deepseek_router_bias_moves_by_its_loads(host_mesh):
    """After one step from the same float32 state, the aux-free router
    biases equal the reference's exactly: the loads are equal exactly, and
    each bias moves by ``update_router_bias`` after the update.  (In
    bfloat16, or after later steps, the two packages' activations differ by
    rounding, a token near a routing tie may take another expert, and a
    load equal to its layer's mean in one package need not be in the
    other.)"""
    arch, shape = "deepseek-v3-671b", "train_4k"
    jb = jax_build_bundle(arch, shape, host_mesh, reduced=True)
    js = jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jb.init_state_fn(jax.random.PRNGKey(0)))
    cfg = reduced_config(ARCHS[arch])
    state = train_state_from_numpy("lm", jax.tree.map(np.asarray, js), cfg, device="cpu")
    start = _params(state)
    batch = _jax_batches(jb, "lm", 1)[0]
    js, _ = jax.jit(jb.step_fn)(js, batch)
    tb = steps.build_bundle(arch, shape, reduced=True, device="cpu")
    state, _ = tb.step_fn(state, {k: T(v) for k, v in batch.items()})
    ref = dict(train_state_from_numpy("lm", jax.tree.map(np.asarray, js), cfg,
                                      device="cpu")["params"].named_parameters())
    got = dict(state["params"].named_parameters())
    biases = [n for n in ref if n.endswith("router_bias")]
    assert biases
    for n in biases:
        assert torch.equal(got[n], ref[n]) and not torch.equal(got[n], start[n]), n


def test_train_kinds_need_no_jax_state():
    """A bundle's own ``init_state_fn`` gives the train state the step takes."""
    tb = steps.build_bundle("meshgraphnet", "molecule", reduced=True, device="cpu")
    state = tb.init_state_fn(3)
    assert set(state["opt"]) == {"mu", "nu", "count"}
    from repro_torch.data.synthetic import graph_batch

    batch = graph_batch(tb.abstract_inputs, seed=0, step=0,
                        n_nodes=tb.abstract_inputs["x"].shape[0], device="cpu")
    state, m = tb.step_fn(state, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["gnorm"])
    assert int(state["opt"]["count"]) == 1


# -- the gradients the steps take -----------------------------------------------------------


def _tied_graph(n=48, e=192, seed=0):
    """A ring plus chords drawn with repeats (``graph_batch``'s recipe):
    many nodes take the same source twice, so maxima and minima tie and
    variances are exactly zero."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.concatenate([(src[: e // 2] + 1) % n, rng.integers(0, n, e - e // 2)])
    return src, dst


#: the std's gradient at a zero variance is 1 / (2 sqrt(1e-6)) = 500 times the
#: variance's rounding, which differs with the summation order (measured 1.1e-5)
TIE_ATOL = {"std": 1e-4}


def _tie_grads(kind, masked):
    n = 48
    src, dst = _tied_graph(n)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((n, 5)).astype(np.float32)
    w = rng.standard_normal((n, 5)).astype(np.float32)
    mask = rng.random(src.size) < 0.8 if masked else None

    def jloss(h):
        out = jax_segment_reduce(h[src], jnp.asarray(dst), n, kind,
                                 mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(h)))
    ht = T(h).requires_grad_(True)
    edges = sort_edges(T(src).to(torch.int32), T(dst).to(torch.int32), n,
                       None if mask is None else T(mask))
    out = segment_reduce(edges.gather_src(ht), edges, kind)
    (out * T(w)).sum().backward()
    return ht.grad.numpy(), jg


@pytest.mark.parametrize("kind", ["max", "min", "std", "mean", "sum"])
@pytest.mark.parametrize("masked", [False, True])
def test_reduction_gradients_at_ties_match_jax(kind, masked, monkeypatch):
    """A tie in a segment's max or min shares its gradient evenly, as JAX's
    does; the other kinds keep JAX's gradient on the same tied graph.
    Control: the gradient of ``torch.segment_reduce`` itself, which does
    not split a tie of more than two."""
    atol = TIE_ATOL.get(kind, 1e-5)
    got, ref = _tie_grads(kind, masked)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    if kind in ("max", "min"):
        monkeypatch.setattr(MP._Extremum, "apply", lambda x, dst, counts, nv, k, backend:
                            torch.segment_reduce(x[:nv], k, lengths=counts, unsafe=True))
    else:
        return
    got, ref = _tie_grads(kind, masked)
    monkeypatch.undo()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def test_gather_rows_gradient_is_the_segment_sum():
    """``gather_rows``' gradient (a segment sum over the sorted index)
    equals ``index_select``'s, with and without ``order``."""
    rng = np.random.default_rng(2)
    table = T(rng.standard_normal((30, 3, 2)).astype(np.float32))
    idx = T(rng.integers(0, 30, 200))
    g = T(rng.standard_normal((200, 3, 2)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    (a.index_select(0, idx) * g).sum().backward()
    b = table.clone().requires_grad_(True)
    (gather_rows(b, idx, order=torch.argsort(idx, stable=True)) * g).sum().backward()
    torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=1e-6)
    s_idx, perm = torch.sort(idx, stable=True)
    c = table.clone().requires_grad_(True)
    (gather_rows(c, s_idx) * g[perm]).sum().backward()
    torch.testing.assert_close(c.grad, a.grad, rtol=1e-6, atol=1e-6)


def _lm_model(arch, remat, dtype=jnp.float32):
    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    from repro.models.transformer import init_lm_params

    params = jax.tree.map(lambda x: x.astype(dtype), init_lm_params(jax.random.PRNGKey(0), jcfg))
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), remat=remat)
    return jcfg, params, lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")


def _grads(model, tokens):
    loss, _ = lm_loss_and_stats(model, tokens)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gs = torch.autograd.grad(loss, [dict(model.named_parameters())[n] for n in names],
                             allow_unused=True)
    return loss, dict(zip(names, gs))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_remat_and_chunk_checkpoints_keep_the_gradients(arch, monkeypatch):
    """Under ``remat`` every layer, and under grad every chunk of the
    chunked attention (GQA and MLA), runs checkpointed; the loss and every
    gradient are those of the plain run, and equal ``jax.grad``'s."""
    monkeypatch.setattr(A, "CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr(A, "_ATTN_CHUNK", 8)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 33)).astype(np.int32)
    jcfg, params, plain = _lm_model(arch, remat=False)
    _, _, remat = _lm_model(arch, remat=True)
    calls = []
    real = A.checkpoint
    monkeypatch.setattr(A, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    l0, g0 = _grads(plain, T(tokens))
    n_chunk_calls = len(calls)
    l1, g1 = _grads(remat, T(tokens))
    # every chunk checkpointed; under remat each layer's chunks run again
    assert n_chunk_calls > 0 and len(calls) - n_chunk_calls > n_chunk_calls
    assert float(l0) == float(l1)
    for n in g0:
        if g0[n] is None:
            assert g1[n] is None
            continue
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)
    monkeypatch.setattr("repro.models.attention.CHUNKED_ATTN_THRESHOLD", 16)
    monkeypatch.setattr("repro.models.attention._ATTN_CHUNK", 8)
    jl, jg = jax.value_and_grad(
        lambda p: jax_lm_loss_and_stats(p, jcfg, jnp.asarray(tokens))[0])(params)
    np.testing.assert_allclose(float(l0), float(jl), rtol=1e-5)
    ref = lm_params_from_numpy(jax.tree.map(np.asarray, jg), remat.cfg, device="cpu")
    for n, r in ref.named_parameters():
        if g0.get(n) is not None:
            np.testing.assert_allclose(g0[n].numpy(), r.detach().numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=n)


def test_lm_train_step_moves_every_attention_weight():
    """No attention gradient is dropped: one step moves every layer's
    ``wq``, ``wk``, ``wv`` and ``wo``."""
    tb = steps.build_bundle("tinyllama-1.1b", "train_4k", reduced=True, device="cpu")
    state = tb.init_state_fn(0)
    before = _params(state)
    from repro_torch.data.synthetic import make_batch

    batch = make_batch(tb.abstract_inputs, seed=0, step=0, bounds=tb.input_bounds, device="cpu")
    tb.step_fn(state, batch)
    after = _params(state)
    names = [n for n in after if n.split(".")[-1] in ("wq", "wk", "wv", "wo")]
    assert len(names) == 4 * state["params"].cfg.n_layers
    for n in names:
        assert not torch.equal(before[n], after[n]), n


def test_flash_entry_raises_under_grad(monkeypatch):
    """The CUDA flash kernel has no backward: asked for a gradient, its
    entry raises before it launches (the backend check let through here, on
    the CPU, to reach it)."""
    monkeypatch.setattr(flash_ops, "validate_backend", lambda backend, device: backend)
    launched = []
    monkeypatch.setattr(flash_ops, "flash_fwd", lambda *a, **k: launched.append(1))
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 16, 1, 8), torch.randn(1, 16, 1, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, v, backend="cuda")
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v, backend="cuda")
    assert launched == [1]


def test_flash_torch_backend_gradients_flow():
    """The plain version the CPU runs is differentiable: its gradients
    equal those of the model's plain attention path."""
    rng = np.random.default_rng(4)
    q = T(rng.standard_normal((2, 24, 4, 8)).astype(np.float32)).requires_grad_(True)
    k = T(rng.standard_normal((2, 24, 2, 8)).astype(np.float32)).requires_grad_(True)
    v = T(rng.standard_normal((2, 24, 2, 8)).astype(np.float32)).requires_grad_(True)
    out = flash_attention(q, k, v, causal=True, window=10, backend="torch")
    g = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(t.abs().sum() > 0 for t in g)
    ref = A._sdpa(q, k, v, A.causal_mask(24, 10), A._scale(8))
    g_ref = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_gqa_attend_takes_the_plain_path_under_grad(monkeypatch):
    """``backend=None`` asked for a gradient never reaches the kernel (on a
    card it would raise); without grad it does."""
    seen = []
    monkeypatch.setattr(A, "validate_backend", lambda backend, device: seen.append(backend)
                        or backend or "cuda")
    monkeypatch.setattr(A, "flash_attention", lambda *a, **k: torch.zeros(1, 4, 2, 8))
    cfg = reduced_config(ARCHS["tinyllama-1.1b"])
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 4, 1, 8), torch.randn(1, 4, 1, 8)
    A.gqa_attend(q, k, v, cfg)
    with torch.no_grad():
        A.gqa_attend(q, k, v, cfg)
    assert seen == ["torch", None]


# -- checkpoints, the trainer and the compressed sum -------------------------------------


RANK_TIMEOUT = 300


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "norm": torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16),
                   "empty": torch.zeros((0, 2))},
        "opt": {"mu": {"w": torch.full((3, 4), 0.125, dtype=torch.bfloat16)},
                "count": torch.tensor(7, dtype=torch.int32),
                "ids": torch.tensor([3, -1, 2**31 - 1], dtype=torch.int32)},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# -- checkpoints -----------------------------------------------------------------------


def test_checkpoint_roundtrip_is_exact(tmp_path):
    """bfloat16, float32 and int32 leaves, an empty one and the optimizer's
    state come back bit for bit, in their dtype, as the reference's do."""
    tree = _tree()
    p = str(tmp_path / "x.ckpt")
    save_pytree(p, tree, step=3)
    target = {"params": {k: torch.empty_like(v) for k, v in tree["params"].items()},
              "opt": tree["opt"]}
    back = restore_pytree(p, target)
    for (k, a), (k2, b) in zip(_leaves(tree), _leaves(back)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    # the reference's round trip of the same values gives the same values
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    jp = str(tmp_path / "j.ckpt")
    jax_save_pytree(jp, jtree, step=3)
    jback = jax_restore_pytree(jp, jax.eval_shape(lambda: jtree))
    jflat = dict(_leaves(jback))
    for k, a in _leaves(back):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(jflat[k]).astype(np.float32),
                                      k)


def test_checkpoint_imports_only_the_standard_library_and_torch():
    import repro_torch.ckpt.checkpoint as mod

    src = open(mod.__file__).read()
    imports = set(re.findall(r"^(?:from|import) (\w+)", src, re.M))
    assert imports <= {"__future__", "json", "os", "re", "struct", "threading", "zlib",
                       "torch"}, imports


@pytest.mark.parametrize("fault, error", [
    ({"missing": torch.zeros(2)}, KeyError),
    ({"a": torch.zeros(3)}, ValueError),
    ({"a": torch.zeros(2, 1)}, ValueError),
])
def test_checkpoint_structure_validation(tmp_path, fault, error):
    """A missing leaf raises ``KeyError`` and a wrong shape ``ValueError``,
    in both packages."""
    p = str(tmp_path / "x.ckpt")
    save_pytree(p, {"a": torch.ones(2)})
    with pytest.raises(error):
        restore_pytree(p, fault)
    jp = str(tmp_path / "j.ckpt")
    jax_save_pytree(jp, {"a": jnp.ones((2,))})
    with pytest.raises(error):
        jax_restore_pytree(jp, {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                                for k, v in fault.items()})


def test_checkpointer_retention_keeps_three(tmp_path):
    c = Checkpointer(str(tmp_path))
    for s in (1, 2, 3, 4, 5):
        c.save_async({"x": torch.ones(4) * s}, s)
    c.wait()
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(ckpt_path(str(tmp_path), s))
                                            for s in (3, 4, 5)]
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    back = restore_pytree(ckpt_path(str(tmp_path), 4), {"x": torch.zeros(4)})
    assert torch.equal(back["x"], torch.full((4,), 4.0))


def test_save_async_snapshots_at_the_call(tmp_path):
    """A parameter changed after ``save_async`` returns does not reach the
    file: the tree is copied to host memory at the call."""
    c = Checkpointer(str(tmp_path))
    t = torch.zeros(1 << 20)
    c.save_async({"t": t}, 1)
    t.add_(1.0)
    c.wait()
    back = restore_pytree(ckpt_path(str(tmp_path), 1), {"t": t})
    assert not back["t"].any()


def test_a_failed_async_write_raises_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    c = Checkpointer(str(blocker / "sub"))
    c.save_async({"x": torch.ones(2)}, 1)
    with pytest.raises(OSError):
        c.wait()


# -- the trainer ---------------------------------------------------------------------------


def test_train_loss_decreases():
    """tinyllama ``train_4k`` reduced, 16 steps: the mean of the last four
    losses falls below the first four's (the reference's claim)."""
    out = train("tinyllama-1.1b", "train_4k", steps=16, verbose=False, device="cpu")
    assert len(out["losses"]) == 16
    assert np.mean(out["losses"][-4:]) < np.mean(out["losses"][:4])


def _state_tensors(state) -> dict:
    return dict(train_mod.state_tree(state)["params"]) | {
        f"opt/{k}": v for k, v in _leaves(state["opt"])}


@pytest.mark.parametrize("arch, shape", [("tinyllama-1.1b", "train_4k"),
                                         ("pna", "full_graph_sm")])
def test_crash_restart_resumes_bit_for_bit(tmp_path, arch, shape):
    """10 steps straight against a crash at step 7 and a restart from the
    checkpoint at step 5: steps 5..9 take the same losses, and the final
    parameters and optimizer state are equal, bit for bit."""
    d1 = str(tmp_path / "straight")
    ref = train(arch, shape, steps=10, ckpt_dir=d1, ckpt_every=5, verbose=False,
                device="cpu")
    d2 = str(tmp_path / "crashy")
    with pytest.raises(RuntimeError, match="injected crash at step 7"):
        train(arch, shape, steps=10, ckpt_dir=d2, ckpt_every=5, crash_at=7, verbose=False,
              device="cpu")
    assert latest_step(d2) == 5  # the checkpoint before the crash survived
    out = train(arch, shape, steps=10, ckpt_dir=d2, ckpt_every=5, verbose=False,
                device="cpu")
    assert out["losses"] == ref["losses"][5:]
    a, b = _state_tensors(ref["final_state"]), _state_tensors(out["final_state"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert latest_step(d2) == 10


def test_train_other_families_stay_finite():
    out = train("deepfm", "train_batch", steps=5, verbose=False, device="cpu")
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    out = train("pna", "full_graph_sm", steps=4, verbose=False, device="cpu")
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()


def test_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("pna", "full_graph_sm", steps=1, verbose=False)


def test_train_cli_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--device", "cpu",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    train_mod.main(args + ["--steps", "4"])
    assert latest_step(ck) == 4
    train_mod.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and latest_step(ck) == 6


def test_train_lm_example_tiny_loss_falls(tmp_path, capsys):
    from repro_torch.examples import train_lm

    ck = str(tmp_path / "ck")
    train_lm.main(["--tiny", "--steps", "21", "--batch", "4", "--device", "cpu",
                   "--ckpt-dir", ck])
    out = capsys.readouterr().out
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+)", out)]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert latest_step(ck) == 21
    train_lm.main(["--tiny", "--steps", "22", "--batch", "4", "--device", "cpu",
                   "--ckpt-dir", ck])
    assert "resumed from step 21" in capsys.readouterr().out


# -- compressed all-reduce ---------------------------------------------------------------


def _tie_input():
    """absmax 127, so the scale is 1 and every half is an exact tie."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.25, -126.5, 0.0, 7.5, 1e-3],
                 np.float32)
    return np.concatenate([x, np.linspace(-9, 9, 36, dtype=np.float32)]).reshape(6, 8)


def _jax_psum(x, err):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((1,), ("i",))
    g = shard_map(lambda x, e: jax_compressed_psum(x, "i", e), mesh=mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()), check_rep=False)
    total, new_err = g(jnp.asarray(x), jnp.asarray(err))
    return np.asarray(total), np.asarray(new_err)


@pytest.mark.parametrize("case", ["ties", "random-with-feedback"])
def test_compressed_psum_one_rank_equals_jax_bit_for_bit(case):
    rng = np.random.default_rng(5)
    if case == "ties":
        x, err = _tie_input(), np.zeros((6, 8), np.float32)
    else:
        x = rng.standard_normal((6, 8)).astype(np.float32)
        err = (rng.standard_normal((6, 8)) * 1e-2).astype(np.float32)
    j_total, j_err = _jax_psum(x, err)
    total, new_err = compressed_psum(torch.tensor(x), partition_mesh(1, device="cpu"),
                                     torch.tensor(err))
    assert np.array_equal(total.numpy(), j_total) and np.array_equal(new_err.numpy(), j_err)
    if case == "ties":  # halves round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert list(total.numpy().ravel()[1:7]) == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0]


def _rank_compressed(n_steps):
    """Each rank's input of each step is drawn from (rank, step); the sum
    once, then ``n_steps`` with error feedback and without."""
    mesh = partition_mesh(device="cpu")
    r = mesh.rank
    x0 = torch.tensor(np.random.default_rng([r, 0]).standard_normal((4, 16)).astype(np.float32))
    total, err = compressed_psum(x0, mesh, torch.zeros_like(x0))
    y = x0.to(torch.float32)
    scale = torch.clamp(y.abs().max(), min=1e-30) / 127.0
    deq = torch.clamp(torch.round(y / scale), -127, 127) * scale
    runs = {}
    for feedback in (True, False):
        acc, err, true = torch.zeros(4, 16), torch.zeros(4, 16), torch.zeros(4, 16)
        for s in range(n_steps):
            x = torch.tensor(np.random.default_rng([r, s + 1]).standard_normal((4, 16))
                             .astype(np.float32))
            carried = err if feedback else torch.zeros_like(x)
            quantum = float(torch.abs(x + carried).max()) / 127.0  # this step's scale
            t, err = compressed_psum(x, mesh, carried)
            acc += t
            true += x
        runs[feedback] = (acc, true, quantum)
    return {"total": total, "deq": deq, "runs": runs}


def test_compressed_psum_on_two_gloo_ranks():
    """On 2 ranks the total is the sum of each rank's dequantized input;
    over 20 steps with error feedback the accumulated total stays within one
    quantum of the true sum (without feedback it does not)."""
    res = run_ranks(_rank_compressed, 2, device="cpu", timeout=RANK_TIMEOUT, args=(20,))
    expect = res[0]["deq"] + res[1]["deq"]
    for r in res:
        assert torch.equal(r["total"], expect)
    for feedback in (True, False):
        acc = res[0]["runs"][feedback][0]
        assert torch.equal(acc, res[1]["runs"][feedback][0])  # every rank the same
        true = res[0]["runs"][feedback][1] + res[1]["runs"][feedback][1]
        quantum = max(r["runs"][feedback][2] for r in res)
        err = float((acc - true).abs().max())
        if feedback:
            assert err <= quantum, (err, quantum)
        else:
            assert err > quantum, (err, quantum)
