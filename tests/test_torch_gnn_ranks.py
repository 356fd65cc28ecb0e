"""Port parity, GNN training on ranks: the GNN train bundles of
``repro_torch.launch.steps`` on a mesh's flattened axis (``HostMesh.flat``:
every rank, in rank order), ``data.synthetic.shard_batch`` for graphs,
``models.gnn.GraphShard`` in the four models' message passing,
``dist.sharding``'s row pairs and summed gradients, ``launch.train`` on
ranks, and ``launch.dryrun``'s GNN counts.

Ranks are gloo processes on the CPU (``dist.run_ranks``): one launch of 2
ranks and one of 4.  Every case takes ``N_STEPS`` steps from the JAX
package's state (``convert.train_state_from_numpy``) on the JAX package's
seeded global batches (reduced configs: N = 512, E = 2,048), every rank
holding the whole batch and its step taking the rank's share.  The rank
targets import nothing of JAX; the JAX side runs here.

Bounds:

  * against the JAX package's one-device step (its bundle's ``step_fn``
    under ``jax.jit``): ``tests/test_torch_train.py``'s ``F32``, loss and
    gnorm ``1e-5``, each parameter after the last step ``2e-3`` of its
    update;
  * against the port's one-rank step: ``ONE_RANK``, loss ``1e-5`` and gnorm
    ``1e-4`` (float32 reassociation only; measured at most 1.3e-6 and
    1.5e-6 over every case but one; with a fifth of the edges masked, or
    label masks uneven across the ranks, 5.1e-7).  Two controls must fail
    it: the partial aggregates left unreduced (each rank its own edges'
    sums for its node block), and, with the uneven label masks, the masked
    mean taken per rank (measured 3.5e-3 in loss, 1.4 and more in gnorm);
  * the case but one, PNA on 4 ranks, is held to ``PNA_STD`` after its
    first step (first step: the bounds above): its gradient norm reads
    1.7e-4 off both the port's one rank and the JAX package at step 2, and
    its parameters 0.056 of their update after step 3.  The cause is PNA's
    std, ``sqrt(relu(E[m^2] - E[m]^2) + 1e-6)``, at nodes whose messages
    are all equal (duplicate edges: the batch's ring edges repeat a source):
    there the variance is 0 plus rounding, and its gradient, ``1/(2 sqrt(
    1e-6)) = 500`` times that rounding, changes with the order of the sums.
    On 4 ranks the ring's duplicates fall on two ranks and the gloo ring
    adds their partials in another order than the one rank's sequential
    sum (on 2 ranks they share one).  With std's output replaced by half
    the mean on both sides (``NO_STD``), the same 4-rank case sits within
    ``ONE_RANK`` (measured 3.5e-7 on the gradients), and the JAX package
    and the port's one rank agree only because they sum in the same order;
  * exact: the four R = 4 layouts ``(4, 1)``, ``(2, 2)``, ``(1, 4)`` and
    ``(2, 2, 1)`` give the same losses, gradient norms and states bit for
    bit (the flattened axis is the rank order on each); every rank's state
    is the same; each step's collectives on every axis equal
    ``dryrun.derived_collectives``; a tie split across two ranks takes the
    one-rank gradient (each tied edge ``1/k`` of it), and not with the tie
    count left unsummed (its control); a MeshGraphNet trainer on 2 ranks
    restarts bit for bit, and one rank restores its checkpoint bit for bit.
"""

from __future__ import annotations

import contextlib
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import graph_batch as jax_graph_batch
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.steps import build_bundle as jax_build_bundle
import repro_torch.launch.steps as steps
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.synthetic import graph_batch, shard_batch
from repro_torch.dist import PartitionMesh, run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HostMesh, make_mesh
from repro_torch.launch.train import state_digests, state_tree, train
from repro_torch.models.gnn import PNA, GraphShard, sort_edges
from repro_torch.models.gnn.message_passing import segment_reduce

pytestmark = pytest.mark.mesh

RANK_TIMEOUT = 300.0
N_STEPS = 3
#: tests/test_torch_train.py's float32 bounds against the JAX package
F32 = dict(loss=1e-5, gnorm=1e-5, params=2e-3)
#: R ranks against the port's one rank
ONE_RANK = dict(loss=1e-5, gnorm=1e-4)
#: PNA on 4 ranks after its first step (see the module docstring; about 6x
#: and 4x the readings)
PNA_STD = dict(loss=1e-5, gnorm=1e-3, params=0.2)
CASES = {"pna": "full_graph_sm", "meshgraphnet": "minibatch_lg", "mace": "molecule",
         "dimenet": "molecule"}
LAYOUTS = ((1, 4, 1), (1, 2, 2), (1, 1, 4), (2, 2, 1))
MAIN, UNREDUCED, PER_RANK_MEAN, NO_STD = "main", "unreduced", "per-rank-mean", "no-std"
#: the restart: steps, checkpoint every, crash at
RESTART = (4, 2, 3)


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    # a class's own entry as it stands (a staticmethod stays one)
    old = vars(obj)[attr] if isinstance(obj, type) and attr in vars(obj) else getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _per_rank_mean(ll, w, axis):
    """The control: each rank's own masked mean, their mean returned."""
    loss = -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return loss, axis.all_reduce(loss.detach(), op="sum") / axis.world_size


def _no_std(m, edges, deg, backend, shard=None):
    mean, _ = _MEAN_STD(m, edges, deg, backend, shard)
    return mean, 0.5 * mean


_MEAN_STD = PNA._mean_std


def _variant(variant: str):
    stack = contextlib.ExitStack()
    if variant == UNREDUCED:  # each rank's own edges' sums for its node block
        stack.enter_context(_patched(GraphShard, "scatter", lambda self, p: self.block(p)))
    elif variant == PER_RANK_MEAN:
        stack.enter_context(_patched(steps, "_masked_nll", _per_rank_mean))
    elif variant == NO_STD:
        stack.enter_context(_patched(PNA, "_mean_std", staticmethod(_no_std)))
    return stack


def _masked(batch: dict) -> dict:
    """The batch with a seeded fifth of its edges masked (some nodes then
    have no unmasked in-edge on a rank, or on any)."""
    rng = np.random.default_rng(7)
    mask = rng.random(np.shape(batch["edge_mask"])) >= 0.2
    return dict(batch, edge_mask=mask)


def _uneven(batch: dict) -> dict:
    """The batch with its label mask uneven over two ranks' node blocks:
    every node of the first half, one in nine of the second."""
    mask = np.array(batch["label_mask"])
    half = mask.shape[0] // 2
    mask[half:] = np.arange(mask.shape[0] - half) % 9 == 0
    return dict(batch, label_mask=mask)


# -- the cases, on ranks and on one rank --------------------------------------------


def _run(arch: str, np_state, batches, mesh=None, variant: str = MAIN) -> dict:
    """The case's steps from ``np_state`` on the global ``batches``, on
    ``mesh``'s flattened axis or on one rank: losses, gnorms, each step's
    collectives beside the derived count, the final state's digests (and
    the whole parameters on the lead rank)."""
    cfg = reduced_config(ARCHS[arch])
    with _variant(variant):
        tb = steps.build_bundle(arch, CASES[arch], reduced=True, device="cpu", mesh=mesh)
        state = train_state_from_numpy("gnn", np_state, cfg, device="cpu", mesh=mesh)
        losses, gnorms, counts = [], [], []
        for b in batches:
            before = None if mesh is None else mesh.stats()
            state, m = tb.step_fn(state, {k: torch.as_tensor(np.array(v)) for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            if mesh is not None:
                measured = dryrun.stats_delta(before, mesh.stats())
                derived = dryrun.derived_for(tb, state["params"], mesh)
                counts.append((measured, derived, dryrun.measured_matches(measured, derived)))
    lead = mesh is None or mesh.rank == 0
    params = {n: t.detach().clone() for n, t in state_tree(state)["params"].items()}
    return {"losses": losses, "gnorms": gnorms, "counts": counts,
            "digests": state_digests(state), "params": params if lead else None}


def _ties(mesh) -> dict:
    """``segment_reduce`` max and min with ties split across the ranks: 4
    nodes, 4 edges a rank (node 0 takes one edge of each rank, equal; node
    1 two of rank 0 and one of rank 1, equal; node 2 none), against the
    whole graph on one rank; and the control, the tie counts unsummed."""
    src = torch.tensor([1, 2, 3, 0, 2, 3, 1, 0])
    dst = torch.tensor([0, 1, 1, 3, 0, 1, 3, 3])
    x = torch.tensor([[2.0, -1.0], [5.0, 0.5], [5.0, 0.5], [1.0, 7.0],
                      [2.0, -1.0], [5.0, 0.5], [0.0, 3.0], [4.0, 7.0]])
    g = torch.arange(8.0).reshape(4, 2) + 1.0
    e = src.shape[0] // mesh.flat.world_size
    lo = mesh.flat.rank * e
    shard = GraphShard(mesh.flat, 4)
    out = {}
    for kind in ("max", "min"):
        xx = x if kind == "max" else -x
        whole = xx.clone().requires_grad_(True)
        every = sort_edges(src, dst, 4)
        ref = segment_reduce(every.permute(whole), every, kind)
        (ref * g).sum().backward()
        for variant in ("main", "unsummed"):
            stack = contextlib.ExitStack()
            if variant == "unsummed":
                stack.enter_context(_patched(GraphShard, "sum_ties", lambda self, t: t))
            with stack:
                mine = xx[lo:lo + e].clone().requires_grad_(True)
                edges = sort_edges(src[lo:lo + e], dst[lo:lo + e], 4)
                got = segment_reduce(edges.permute(mine), edges, kind, shard=shard)
                (got * shard.block(g)).sum().backward()
            out[kind, variant] = {"out": got.detach(), "want": shard.block(ref.detach()),
                                  "grad": mine.grad, "want_grad": whole.grad[lo:lo + e]}
    return out


def _restart(root: str) -> dict:
    """MeshGraphNet's trainer on this rank: straight, a crash and its
    resume, checkpoints every ``RESTART[1]`` steps."""
    n, every, crash_at = RESTART
    kw = dict(steps=n, ckpt_every=every, verbose=False, device="cpu")
    ref = train("meshgraphnet", "minibatch_lg", ckpt_dir=f"{root}/straight", **kw)
    crash = None
    try:
        train("meshgraphnet", "minibatch_lg", ckpt_dir=f"{root}/crashy", crash_at=crash_at, **kw)
    except RuntimeError as e:
        crash = str(e)
    out = train("meshgraphnet", "minibatch_lg", ckpt_dir=f"{root}/crashy", **kw)
    return {"losses": ref["losses"], "digests": state_digests(ref["final_state"]),
            "crash": crash, "resumed_from": out["resumed_from"],
            "resumed_losses": out["losses"], "resumed_digests": state_digests(out["final_state"]),
            "flat_calls": ref["flat_stats"]["calls"]}


def _rank(cases: dict, layouts: tuple, root: str | None) -> dict:
    """One rank of a launch: every case on each mesh of ``layouts`` (the
    first with the ties, the controls, the uneven label masks and the
    masked edges), then, given ``root``, the restart."""
    out = {}
    for dims in layouts:
        mesh = make_mesh(pod=dims[0], data=dims[1], model=dims[2], device="cpu")
        for arch, (np_state, batches) in cases.items():
            out[dims, arch] = _run(arch, np_state, batches, mesh)
        if dims == layouts[0]:
            out["rank"], out["shape"] = mesh.rank, mesh.shape
            out["ties"] = _ties(mesh)
            np_state, batches = cases["pna"]
            out[UNREDUCED] = _run("pna", np_state, batches[:1], mesh, UNREDUCED)
            uneven = [_uneven(batches[0])]
            out["uneven"] = _run("pna", np_state, uneven, mesh)
            out[PER_RANK_MEAN] = _run("pna", np_state, uneven, mesh, PER_RANK_MEAN)
            out[NO_STD] = _run("pna", np_state, batches, mesh, NO_STD)
            out["masked"] = {arch: _run(arch, cases[arch][0], [_masked(cases[arch][1][0])], mesh)
                             for arch in cases}
    if root is not None:
        out["restart"] = _restart(root)
    return out


# -- the JAX package's side ---------------------------------------------------------


def _jax_case(arch: str):
    """The JAX bundle's initial state (numpy), its seeded global batches and
    its steps under ``jax.jit``: ``(np_state, batches, metrics, its final
    parameters in the port's layout)``."""
    jb = jax_build_bundle(arch, CASES[arch], jax_host_mesh(), reduced=True)
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, js)
    inputs = jb.abstract_inputs
    n_nodes = (inputs.get("x") or inputs["species"]).shape[0]
    batches = [jax.tree.map(np.asarray, jax_graph_batch(inputs, seed=0, step=i, n_nodes=n_nodes))
               for i in range(N_STEPS)]
    step = jax.jit(jb.step_fn)
    metrics = []
    for b in batches:
        js, m = step(js, b)
        metrics.append((float(m["loss"]), float(m["gnorm"])))
    end = train_state_from_numpy("gnn", jax.tree.map(np.asarray, js),
                                 reduced_config(ARCHS[arch]), device="cpu")
    return np_state, batches, metrics, dict(end["params"].named_parameters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's steps, the port's one-rank steps (and the uneven
    masks' one-rank step), and one launch of 2 ranks and one of 4."""
    cases, out = {}, {}
    for arch in CASES:
        np_state, batches, jm, j_end = _jax_case(arch)
        cases[arch] = (np_state, batches)
        start = train_state_from_numpy("gnn", np_state, reduced_config(ARCHS[arch]),
                                       device="cpu")["params"]
        out[arch] = {"jax": (jm, j_end), "one": _run(arch, np_state, batches),
                     "start": {n: p.detach().clone() for n, p in start.named_parameters()}}
    np_state, batches = cases["pna"]
    out["uneven"] = _run("pna", np_state, [_uneven(batches[0])])
    out[NO_STD] = _run("pna", np_state, batches, variant=NO_STD)
    out["masked"] = {arch: _run(arch, cases[arch][0], [_masked(cases[arch][1][0])])
                     for arch in CASES}
    root = str(tmp_path_factory.mktemp("gnn_ranks"))
    launches = {2: run_ranks(_rank, 2, device="cpu", timeout=RANK_TIMEOUT,
                             args=(cases, ((1, 2, 1),), root)),
                4: run_ranks(_rank, 4, device="cpu", timeout=RANK_TIMEOUT,
                             args=(cases, LAYOUTS, None))}
    return out, launches, root


def _first(r: int) -> tuple:
    return (1, 2, 1) if r == 2 else LAYOUTS[0]


def _off(got: dict, ref: dict) -> dict:
    """The largest relative distance of the losses and the gradient norms."""
    return {k: max(abs(a - b) / abs(b) for a, b in zip(got[key], ref[key]))
            for k, key in (("loss", "losses"), ("gnorm", "gnorms"))}


def _within(got: dict, ref: dict, tol: dict) -> bool:
    off = _off(got, ref)
    return all(off[k] <= tol[k] for k in off)


def _after_first(arch: str, ranks: int, tol: dict) -> dict:
    """The bounds of steps 2 on (see ``PNA_STD``)."""
    return PNA_STD if (arch, ranks) == ("pna", 4) else tol


def _steps(got: dict, first: bool) -> dict:
    return {k: got[k][:1] if first else got[k][1:] for k in ("losses", "gnorms")}


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("arch", tuple(CASES))
def test_ranks_match_the_jax_one_device_step(runs, arch, ranks):
    out, launches, _ = runs
    jm, j_end = out[arch]["jax"]
    got = launches[ranks][0][_first(ranks), arch]
    later = _after_first(arch, ranks, F32)
    for i, ((jl, jg), tl, tg) in enumerate(zip(jm, got["losses"], got["gnorms"])):
        tol = F32 if i == 0 else later
        np.testing.assert_allclose(tl, jl, rtol=tol["loss"])
        np.testing.assert_allclose(tg, jg, rtol=tol["gnorm"])
    start = out[arch]["start"]
    for name, p in got["params"].items():
        r = j_end[name].detach().float()
        moved = (r - start[name].float()).norm()
        diff = (p.float() - r).norm()
        if moved == 0:
            assert diff == 0, name
            continue
        assert float(diff / moved) <= later["params"], (name, float(diff / moved))


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("arch", tuple(CASES))
def test_ranks_match_one_rank_and_agree(runs, arch, ranks):
    """Within ``ONE_RANK`` of the port's one-rank steps, every rank's state
    the same bit for bit (the parameters are replicated)."""
    out, launches, _ = runs
    got = [r[_first(ranks), arch] for r in launches[ranks]]
    one = out[arch]["one"]
    for first in (True, False):
        tol = ONE_RANK if first else _after_first(arch, ranks, ONE_RANK)
        assert _within(_steps(got[0], first), _steps(one, first), tol), _off(got[0], one)
    assert all(g["digests"] == got[0]["digests"] and g["losses"] == got[0]["losses"]
               for g in got)


@pytest.mark.parametrize("arch", tuple(CASES))
def test_four_layouts_are_bit_identical(runs, arch):
    _, launches, _ = runs
    for r in launches[4]:
        first = r[LAYOUTS[0], arch]
        for dims in LAYOUTS[1:]:
            got = r[dims, arch]
            assert got["losses"] == first["losses"] and got["gnorms"] == first["gnorms"], dims
            assert got["digests"] == first["digests"], dims


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("arch", tuple(CASES))
def test_collectives_equal_the_derived_count(runs, arch, ranks):
    """Every step on every rank and layout: calls and bytes per axis, all
    on the flattened one."""
    _, launches, _ = runs
    for r in launches[ranks]:
        for dims in ((1, 2, 1),) if ranks == 2 else LAYOUTS:
            for measured, derived, matches in r[dims, arch]["counts"]:
                assert matches, (dims, measured, derived)
                assert set(measured["flat"]["calls"]) == {"all_gather", "reduce_scatter",
                                                          "all_reduce"}
                assert all(not measured[a]["calls"] for a in measured if a != "flat")


@pytest.mark.parametrize("ranks", (2, 4))
def test_unreduced_aggregate_control_fails(runs, ranks):
    out, launches, _ = runs
    got = launches[ranks][0][UNREDUCED]
    one = {k: v[:1] for k, v in out["pna"]["one"].items() if k in ("losses", "gnorms")}
    assert not _within(got, one, ONE_RANK), _off(got, one)


@pytest.mark.parametrize("ranks", (2, 4))
def test_pna_without_std_keeps_the_one_rank_bound(runs, ranks):
    """What moves PNA on 4 ranks is its std (see ``PNA_STD``): with std's
    output replaced on both sides, every step sits within ``ONE_RANK``;
    with it, 4 ranks leave that bound."""
    out, launches, _ = runs
    got = launches[ranks][0][NO_STD]
    assert _within(got, out[NO_STD], ONE_RANK), _off(got, out[NO_STD])
    if ranks == 4:
        real = launches[4][0][_first(4), "pna"]
        assert not _within(real, out["pna"]["one"], ONE_RANK)


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("arch", tuple(CASES))
def test_masked_edges_match_one_rank(runs, arch, ranks):
    """A fifth of the edges masked (max and min fill them with -inf / +inf
    on each rank before the cross-rank reduction): one step within
    ``ONE_RANK`` of one rank."""
    out, launches, _ = runs
    got = launches[ranks][0]["masked"][arch]
    assert _within(got, out["masked"][arch], ONE_RANK), _off(got, out["masked"][arch])


@pytest.mark.parametrize("ranks", (2, 4))
def test_uneven_masks_give_the_global_masked_mean(runs, ranks):
    """Label masks uneven across the ranks: the global masked mean and its
    gradient; the per-rank masked mean (the control) misses both."""
    out, launches, _ = runs
    got = launches[ranks][0]["uneven"]
    assert _within(got, out["uneven"], ONE_RANK), _off(got, out["uneven"])
    ctrl = launches[ranks][0][PER_RANK_MEAN]
    off = _off(ctrl, out["uneven"])
    assert off["loss"] > ONE_RANK["loss"] and off["gnorm"] > ONE_RANK["gnorm"], off


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("kind", ("max", "min"))
def test_ties_split_across_ranks_take_the_one_rank_gradient(runs, kind, ranks):
    _, launches, _ = runs
    for r in launches[ranks]:
        t = r["ties"][kind, "main"]
        assert torch.equal(t["out"], t["want"])
        assert torch.allclose(t["grad"], t["want_grad"], rtol=0, atol=1e-6)
    # the control fails on the rank whose tie is split (node 0 or node 1)
    ctrl = [r["ties"][kind, "unsummed"] for r in launches[ranks]]
    assert any(not torch.allclose(c["grad"], c["want_grad"], rtol=0, atol=1e-6) for c in ctrl)


def test_meshgraphnet_trainer_restarts_on_two_ranks_and_onto_one(runs, tmp_path):
    _, launches, root = runs
    n, every, crash_at = RESTART
    rs = [r["restart"] for r in launches[2]]
    r0 = rs[0]
    assert all(r == r0 for r in rs)  # the ranks agree, their states too
    assert r0["crash"] == f"injected crash at step {crash_at}" and r0["resumed_from"] == every
    assert r0["resumed_losses"] == r0["losses"][every:]
    assert r0["resumed_digests"] == r0["digests"]
    assert r0["flat_calls"]["reduce_scatter"] > 0
    # one rank restores the 2-rank checkpoint: no step left, the state is it
    one = str(tmp_path / "one")
    shutil.copytree(f"{root}/straight", one)
    restored = train("meshgraphnet", "minibatch_lg", steps=n, ckpt_dir=one, verbose=False,
                     device="cpu", ranks=1)
    assert restored["resumed_from"] == n and not restored["losses"]
    assert state_digests(restored["final_state"]) == r0["digests"]


# -- the bundles and the batch alone ------------------------------------------------


def _fake_mesh(n: int, rank: int) -> HostMesh:
    return HostMesh(PartitionMesh(n, rank, torch.device("cpu"), None))


@pytest.mark.parametrize("arch", tuple(CASES))
def test_graph_batch_splits_over_the_flattened_axis(arch):
    """Each rank's edge, triplet and node blocks laid end to end give the
    global batch back; a regression's per-graph labels stay whole; the ids
    stay global."""
    tb = steps.build_bundle(arch, CASES[arch], reduced=True, device="cpu")
    inputs = tb.abstract_inputs
    n_nodes = (inputs.get("x") or inputs["species"]).shape[0]
    batch = graph_batch(inputs, seed=0, step=0, n_nodes=n_nodes, device="cpu")
    parts = [shard_batch(batch, _fake_mesh(4, r)) for r in range(4)]
    for k, t in batch.items():
        if k == "labels" and "graph_id" in batch:
            assert all(p[k] is t for p in parts)
            continue
        assert parts[1][k].shape[0] == t.shape[0] // 4, k
        assert torch.equal(torch.cat([p[k] for p in parts]), t), k
    assert int(parts[3]["edge_src"].max()) >= n_nodes // 4  # global ids


def test_graph_arrays_four_ranks_cannot_split_stay_whole():
    batch = {"edge_src": torch.arange(6), "edge_dst": torch.arange(6), "x": torch.ones(8, 2),
             "labels": torch.arange(8), "label_mask": torch.ones(8, dtype=torch.bool)}
    got = shard_batch(batch, _fake_mesh(4, 1))
    assert got["edge_src"] is batch["edge_src"]
    assert torch.equal(got["labels"], torch.tensor([2, 3])) and got["x"].shape == (2, 2)


def test_production_gnn_cell_is_reckoned_on_the_flat_axis():
    """The production reckoning puts every GNN collective on ``flat``: a
    PNA step at ogb_products on 256 ranks."""
    rec = dryrun.reckon_cell("pna", "ogb_products", "single")
    calls = rec["collectives"]["per_axis"]["calls"]
    assert rec["ok"] and calls["data"] == {} and calls["model"] == {}
    assert calls["flat"]["reduce_scatter"] == 1 + 4 * (2 + 1)  # degrees; sums, gathers' grads
    assert calls["flat"]["all_reduce"] == 4 * 2 * 2 + 1 + 1  # extrema and ties; loss; grads

