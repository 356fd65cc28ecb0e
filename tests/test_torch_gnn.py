"""Port parity, the GNN stack: ``repro_torch.models`` (PNA, MeshGraphNet,
MACE, DimeNet, their message-passing primitives and the E(3) toolkit),
``repro_torch.configs``, ``repro_torch.graph.sampler`` and the
``segment_sum`` autograd entry, against the JAX package on the CPU.

Inputs are made with numpy from seeds; graphs come from ``repro.graph``;
parameters are the JAX package's own (``init_pna`` and its siblings, the
key of ``tests/test_archs_gnn.py``'s fixture) carried across by
``repro_torch.convert.gnn_params_from_numpy``.  The JAX side runs
``jax.ops.segment_*``; the port runs backend ``torch`` (the kernel's plain
version) through the same entry points the card runs.

Tolerances: PNA outputs ``atol=1e-5`` and MeshGraphNet outputs
``atol=4e-5`` (|out| up to 20; both about ten times the error measured
here), MACE and DimeNet energies ``rtol=1e-5`` (DimeNet stood at 1.2e-6
here, and a bound of 2e-6 failed now and then under a loaded run), PNA grads
``rtol=1e-3, atol=1e-5``, the segment reductions ``atol=1e-6``,
invariance under rotation ``rtol=2e-5`` (``tests/test_archs_gnn.py``'s).
Only the summation order differs from JAX's scatter.  The configs, the Gaunt
tensor, the numpy helpers and the sampler's batches are equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as jax_common
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.graph.generators import erdos_renyi_graph
from repro.graph.sampler import NeighborSampler as JaxSampler
from repro.models.gnn import e3 as jax_e3
from repro.models.gnn.dimenet import build_triplets as jax_build_triplets
from repro.models.gnn.dimenet import dimenet_forward, init_dimenet
from repro.models.gnn.mace import init_mace, mace_forward
from repro.models.gnn.meshgraphnet import init_mgn, mgn_forward
from repro.models.gnn.message_passing import degrees as jax_degrees
from repro.models.gnn.message_passing import segment_reduce as jax_segment_reduce
from repro.models.gnn.pna import init_pna, pna_forward
import repro_torch.models.common as common
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.graph.structs import Graph
from repro_torch.kernels.segment_sum import reference_segment_sum, segment_sum
from repro_torch.models.gnn import MACE, PNA, DimeNet, MeshGraphNet, e3, sort_edges
from repro_torch.models.gnn.dimenet import build_triplets
from repro_torch.models.gnn.message_passing import degrees, segment_reduce

N = 80
PNA_ATOL, MGN_ATOL, ENERGY_RTOL = 1e-5, 4e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
SEG_ATOL = 1e-6
ROTATIONS = [(0.7, [1.0, 2.0, 3.0]), (2.1, [0.0, 1.0, 0.0])]
KINDS = ("sum", "mean", "max", "min", "std")


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat_tree(tree, prefix=""):
    """A parameter tree's leaves by the port's parameter names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}."))
    return out


@pytest.fixture(scope="module")
def graph():
    g = erdos_renyi_graph(N, 6.0, seed=3)
    rng = np.random.default_rng(1)
    return dict(
        g=g,
        src=g.src,
        dst=g.dst,
        pos=rng.standard_normal((N, 3)).astype(np.float32),
        species=rng.integers(0, 10, N).astype(np.int32),
        feats=rng.standard_normal((N, 12)).astype(np.float32),
        labels=rng.integers(0, 5, N).astype(np.int32),
        e_feat=rng.standard_normal((g.n_edges, 4)).astype(np.float32),
        mask=rng.random(g.n_edges) < 0.8,
        key=jax.random.PRNGKey(1),
    )


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_and_reduced_configs_match_jax(arch):
    ref, spec = JAX_ARCHS[arch], ARCHS[arch]
    for field in ("arch_id", "family", "shape_names", "skip_shapes", "source"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert dataclasses.asdict(spec.config) == dataclasses.asdict(ref.config)
    assert type(spec.config).__name__ == type(ref.config).__name__
    assert {k: dataclasses.asdict(v) for k, v in spec.shapes().items()} == {
        k: dataclasses.asdict(v) for k, v in ref.shapes().items()
    }
    red, red_ref = reduced_config(spec), jax_reduced_config(ref)
    assert dataclasses.asdict(red) == dataclasses.asdict(red_ref)
    if spec.family == "lm":
        assert red.param_count() == red_ref.param_count()
        assert spec.config.active_param_count() == ref.config.active_param_count()


# -- models/common.py ---------------------------------------------------------


def test_common_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(T(x), T(scale)).numpy(),
        np.asarray(jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-6)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    cos, sin = common.rope_angles(T(pos), 16, theta=1e6)
    jcos, jsin = jax_common.rope_angles(jnp.asarray(pos), 16, theta=1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(
        common.apply_rope(T(x), cos[:, :, None], sin[:, :, None]).numpy(),
        np.asarray(jax_common.apply_rope(jnp.asarray(x), jcos[:, :, None], jsin[:, :, None])),
        atol=1e-5)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(
        common.swiglu(T(x), *map(T, w)).numpy(),
        np.asarray(jax_common.swiglu(jnp.asarray(x), *map(jnp.asarray, w))), atol=1e-5)
    logits = rng.standard_normal((3, 5, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (3, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        np.testing.assert_allclose(
            float(common.cross_entropy_loss(T(logits), T(labels), z_loss=z)),
            float(jax_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                                z_loss=z)), rtol=1e-6)


def test_init_dense_draws_from_its_generator():
    a = common.init_dense(torch.Generator().manual_seed(3), 400, 300)
    b = common.init_dense(torch.Generator().manual_seed(3), 400, 300)
    assert a.dtype == torch.bfloat16 and a.shape == (400, 300)
    assert torch.equal(a, b)
    ref = np.asarray(jax_common.init_dense(jax.random.PRNGKey(0), 400, 300), np.float32)
    # different draws, the same law: std 1/sqrt(d_in)
    for w in (a.float().numpy(), ref):
        assert abs(w.std() * np.sqrt(400) - 1.0) < 0.02 and abs(w.mean()) < 3e-3


# -- segment reductions ---------------------------------------------------------


def _seg_graph(seed=0):
    """12 nodes: 9 receive edges, node 3's in-edges all masked, nodes 9-11
    isolated; one inf value sits under the mask."""
    rng = np.random.default_rng(seed)
    e = 60
    dst = rng.integers(0, 9, e).astype(np.int32)
    src = rng.integers(0, 12, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    mask[dst == 3] = False
    x = rng.standard_normal((e, 5)).astype(np.float32)
    masked = np.flatnonzero(~mask)
    x[masked[0], 2] = np.inf
    return src, dst, mask, x, 12


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("kind", KINDS)
def test_segment_reduce_matches_jax(kind, masked):
    src, dst, mask, x, n = _seg_graph()
    if not masked:
        x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    m = mask if masked else None
    edges = sort_edges(T(src), T(dst), n, None if m is None else T(m))
    out = segment_reduce(edges.permute(T(x)), edges, kind)
    ref = np.asarray(jax_segment_reduce(jnp.asarray(x), jnp.asarray(dst), n, kind,
                                        mask=None if m is None else jnp.asarray(m)))
    assert out.shape == (n, 5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=SEG_ATOL)
    # isolated vertices reduce to 0 (std to sqrt(1e-6), as in JAX), and so
    # does the fully masked one where no masked inf reaches it (the sums
    # carry inf * 0 = nan)
    empty = np.sqrt(np.float32(1e-6)) if kind == "std" else 0.0
    np.testing.assert_allclose(out[9:].numpy(), empty, rtol=1e-6)
    if masked and kind in ("max", "min"):
        assert (out[3] == 0).all()
    np.testing.assert_allclose(
        degrees(edges).numpy(),
        np.asarray(jax_degrees(jnp.asarray(dst), n, mask=None if m is None else jnp.asarray(m))))


@pytest.mark.parametrize("kind", KINDS)
def test_segment_reduce_drops_out_of_range_ids(kind):
    src, dst, _, x, n = _seg_graph(1)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    dst = dst.copy()
    dst[::7] = -1
    dst[3::7] = n + 2
    edges = sort_edges(T(src), T(dst), n)
    assert edges.n_valid == int(((dst >= 0) & (dst < n)).sum())
    out = segment_reduce(edges.permute(T(x)), edges, kind)
    ref = np.asarray(jax_segment_reduce(jnp.asarray(x), jnp.asarray(dst), n, kind))
    np.testing.assert_allclose(out.numpy(), ref, atol=SEG_ATOL)


def test_segment_sum_entry_gradient_is_the_gather():
    """The autograd entry's backward equals torch's own derivative of the
    plain version (``index_add_``), dropped ids getting 0."""
    rng = np.random.default_rng(2)
    n, e = 17, 90
    ids = np.sort(rng.integers(-2, n + 2, e)).astype(np.int32)
    vals = rng.standard_normal((e, 4, 3)).astype(np.float32)
    up = rng.standard_normal((n, 4, 3)).astype(np.float32)
    v1 = T(vals).requires_grad_()
    out = segment_sum(T(ids), v1, n, sorted_ids=True)
    (out * T(up)).sum().backward()
    v2 = T(vals).requires_grad_()
    ref = reference_segment_sum(T(ids), v2.reshape(e, 12), n).reshape(n, 4, 3)
    (ref * T(up)).sum().backward()
    assert out.shape == (n, 4, 3)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-6)
    np.testing.assert_array_equal(v1.grad.numpy(), v2.grad.numpy())
    dropped = (ids < 0) | (ids >= n)
    assert dropped.any() and (v1.grad.numpy()[dropped] == 0).all()


# -- the four models ---------------------------------------------------------


def _pna(graph):
    cfg = reduced_config(ARCHS["pna"])
    params = init_pna(graph["key"], cfg, 12, 5)
    return cfg, params, gnn_params_from_numpy("pna", numpy_tree(params), cfg, device="cpu")


@pytest.mark.parametrize("masked", [False, True], ids=["all-edges", "edge-mask"])
def test_pna_forward_matches_jax(graph, masked):
    cfg, params, model = _pna(graph)
    assert len(cfg.extra["aggregators"]) * len(cfg.extra["scalers"]) == 12
    mask = graph["mask"] if masked else None
    ref = pna_forward(params, cfg, jnp.asarray(graph["feats"]), jnp.asarray(graph["src"]),
                      jnp.asarray(graph["dst"]),
                      edge_mask=None if mask is None else jnp.asarray(mask))
    out = model(T(graph["feats"]), T(graph["src"]), T(graph["dst"]),
                edge_mask=None if mask is None else T(mask))
    assert out.shape == (N, 5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=PNA_ATOL)
    # edges sorted once by the caller give the same output
    edges = sort_edges(T(graph["src"]), T(graph["dst"]), N, None if mask is None else T(mask))
    assert torch.equal(model(T(graph["feats"]), edges), out)


def test_pna_grads_match_jax_grad(graph):
    """The loss of ``tests/test_archs_gnn.py``; the port's gradient flows
    through the segment-sum autograd entry on the plain version."""
    cfg, params, model = _pna(graph)
    x, labels = graph["feats"], graph["labels"]
    src, dst = jnp.asarray(graph["src"]), jnp.asarray(graph["dst"])

    def loss(p):
        lg = pna_forward(p, cfg, jnp.asarray(x), src, dst)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(N), labels])

    ref_loss, ref_grads = jax.value_and_grad(loss)(params)
    lg = model(T(x), T(graph["src"]), T(graph["dst"]))
    out_loss = -torch.log_softmax(lg, -1)[torch.arange(N), T(labels).long()].mean()
    out_loss.backward()
    np.testing.assert_allclose(out_loss.item(), float(ref_loss), rtol=1e-6)
    ref_flat = flat_tree(numpy_tree(ref_grads))
    names = dict(model.named_parameters())
    assert set(ref_flat) == set(names)
    for name, g_ref in ref_flat.items():
        np.testing.assert_allclose(names[name].grad.numpy(), g_ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def _sampled_batch(seed=0):
    """One NeighborSampler batch as one edge list over its node slots."""
    g = erdos_renyi_graph(300, 4.0, seed=9)
    batch = JaxSampler(g, (4, 3), seed=seed).sample(np.arange(10, dtype=np.int64))
    slots = [batch.blocks[-1].dst_nodes] + [blk.src_nodes for blk in reversed(batch.blocks)]
    starts = np.cumsum([0] + [s.size for s in slots])
    src, dst, mask = [], [], []
    for h, blk in enumerate(reversed(batch.blocks)):  # seed-side block first
        src.append(blk.edge_src + starts[h + 1])
        dst.append(blk.edge_dst + starts[h])
        mask.append(blk.edge_mask)
    return (np.concatenate(slots), np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32), np.concatenate(mask))


@pytest.mark.parametrize("case", ["erdos-renyi", "sampled-batch"])
def test_meshgraphnet_forward_matches_jax(graph, case):
    cfg = reduced_config(ARCHS["meshgraphnet"])
    rng = np.random.default_rng(4)
    if case == "erdos-renyi":
        x, src, dst, mask = graph["feats"], graph["src"], graph["dst"], None
    else:
        nodes, src, dst, mask = _sampled_batch()
        x = rng.standard_normal((300, 12)).astype(np.float32)[nodes]
    ef = rng.standard_normal((src.size, 4)).astype(np.float32)
    params = init_mgn(graph["key"], cfg, 12, 4, 3)
    ref = mgn_forward(params, cfg, jnp.asarray(x), jnp.asarray(ef), jnp.asarray(src),
                      jnp.asarray(dst), edge_mask=None if mask is None else jnp.asarray(mask))
    model = gnn_params_from_numpy("meshgraphnet", numpy_tree(params), cfg, device="cpu")
    assert isinstance(model, MeshGraphNet)
    out = model(T(x), T(ef), T(src), T(dst), edge_mask=None if mask is None else T(mask))
    assert out.shape == (x.shape[0], 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=MGN_ATOL)


def test_mace_matches_jax_and_is_e3_invariant(graph):
    cfg = reduced_config(ARCHS["mace"])
    params = init_mace(graph["key"], cfg)
    model = gnn_params_from_numpy("mace", numpy_tree(params), cfg, device="cpu")
    assert isinstance(model, MACE)
    sp, pos = graph["species"], graph["pos"]
    args = (T(graph["src"]), T(graph["dst"]))
    ref = mace_forward(params, cfg, jnp.asarray(sp), jnp.asarray(pos),
                       jnp.asarray(graph["src"]), jnp.asarray(graph["dst"]))
    with torch.no_grad():
        e1 = model(T(sp), T(pos), *args)
        assert e1.shape == (1,)
        np.testing.assert_allclose(e1.numpy(), np.asarray(ref), rtol=ENERGY_RTOL)
        for angle, axis in ROTATIONS:
            r = e3.rotation_matrix(np.array(axis), angle).astype(np.float32)
            e2 = model(T(sp), T(pos @ r.T + 5.0), *args)
            np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=2e-5)


def test_dimenet_batched_matches_jax_and_is_rotation_invariant(graph):
    cfg = reduced_config(ARCHS["dimenet"])
    kj, ji, tmask = build_triplets(graph["src"], graph["dst"], 1500)
    for a, b in zip((kj, ji, tmask), jax_build_triplets(graph["src"], graph["dst"], 1500)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    params = init_dimenet(graph["key"], cfg)
    model = gnn_params_from_numpy("dimenet", numpy_tree(params), cfg, device="cpu")
    assert isinstance(model, DimeNet)
    gid = (np.arange(N) >= 40).astype(np.int32)  # two fake graphs
    sp, pos = graph["species"], graph["pos"]
    ref = dimenet_forward(params, cfg, jnp.asarray(sp), jnp.asarray(pos),
                          jnp.asarray(graph["src"]), jnp.asarray(graph["dst"]), jnp.asarray(kj),
                          jnp.asarray(ji), trip_mask=jnp.asarray(tmask),
                          graph_id=jnp.asarray(gid), n_graphs=2)

    def run(p, graph_id=None, n_graphs=1):
        return model(T(sp), T(p), T(graph["src"]), T(graph["dst"]), T(kj), T(ji),
                     trip_mask=T(tmask), graph_id=graph_id, n_graphs=n_graphs)

    with torch.no_grad():
        out = run(pos, T(gid), 2)
        assert out.shape == (2, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ENERGY_RTOL)
        # per-graph energies: their sum over both graphs nearly cancels here
        # (-0.094 of two terms near 8.5), below float32's relative reach
        r = e3.rotation_matrix(np.array([1.0, 0.5, -1.0]), 1.1).astype(np.float32)
        np.testing.assert_allclose(out.numpy(), run(pos @ r.T, T(gid), 2).numpy(), rtol=2e-5)
        np.testing.assert_allclose(run(pos).numpy(), out.numpy().sum(0, keepdims=True), atol=1e-5)


def test_models_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    cfg = reduced_config(ARCHS["pna"])
    for build in (lambda: PNA(cfg, 3, 2), lambda: MACE(reduced_config(ARCHS["mace"])),
                  lambda: gnn_params_from_numpy("pna", numpy_tree(
                      init_pna(jax.random.PRNGKey(0), cfg, 3, 2)), cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_gnn_params_from_numpy_checks_the_tree():
    cfg = reduced_config(ARCHS["pna"])
    tree = numpy_tree(init_pna(jax.random.PRNGKey(0), cfg, 6, 4))
    model = gnn_params_from_numpy("pna", tree, cfg, device="cpu")
    for name, value in flat_tree(tree).items():
        assert np.array_equal(dict(model.named_parameters())[name].detach().numpy(), value)
    tree["layers"][0]["msg"]["w"][0] = tree["layers"][0]["msg"]["w"][0][:, :3]
    with pytest.raises(ValueError, match="layers.0.msg.w.0"):
        gnn_params_from_numpy("pna", tree, cfg, device="cpu")
    del tree["decode"]
    with pytest.raises(KeyError):
        gnn_params_from_numpy("pna", tree, cfg, device="cpu")


def test_models_draw_their_init_from_the_generator():
    cfg = reduced_config(ARCHS["dimenet"])
    a = DimeNet(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    b = DimeNet(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    names = {n for n, _ in a.named_parameters()}
    assert names == set(flat_tree(numpy_tree(init_dimenet(jax.random.PRNGKey(0), cfg))))


# -- E(3) toolkit ---------------------------------------------------------------


def test_e3_numpy_half_is_the_reference_and_torch_half_matches():
    assert np.array_equal(e3.gaunt_tensor(), jax_e3.gaunt_tensor())
    g = e3.gaunt_tensor()
    np.testing.assert_allclose(g[1, 1, 0], 1 / 3, rtol=1e-12)
    np.testing.assert_allclose(g[1, 2, 4], 1 / np.sqrt(3), rtol=1e-12)
    assert np.abs(g[1:4, 1:4, 1:4]).max() == 0.0
    axis = np.array([0.3, -1.0, 2.0])
    assert np.array_equal(e3.rotation_matrix(axis, 0.4), jax_e3.rotation_matrix(axis, 0.4))
    rng = np.random.default_rng(8)
    v = rng.standard_normal((50, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    assert np.array_equal(e3.real_sh_np(v), jax_e3.real_sh_np(v))
    v32 = v.astype(np.float32)
    np.testing.assert_allclose(e3.real_sh(T(v32)).numpy(),
                               np.asarray(jax_e3.real_sh(jnp.asarray(v32))), atol=1e-6)
    r = rng.uniform(0.0, 6.0, 64).astype(np.float32)
    np.testing.assert_allclose(e3.bessel_rbf(T(r), 8, 5.0).numpy(),
                               np.asarray(jax_e3.bessel_rbf(jnp.asarray(r), 8, 5.0)), atol=1e-5)
    np.testing.assert_allclose(e3.cutoff_envelope(T(r), 5.0).numpy(),
                               np.asarray(jax_e3.cutoff_envelope(jnp.asarray(r), 5.0)),
                               atol=1e-6)


# -- the sampler ------------------------------------------------------------------


def test_neighbor_sampler_is_byte_identical():
    g = erdos_renyi_graph(500, 8.0, seed=11)
    mine = NeighborSampler(Graph(g.n_vertices, g.src, g.dst), fanouts=(5, 3), seed=0)
    ref = JaxSampler(g, fanouts=(5, 3), seed=0)
    for seeds in (np.arange(16, dtype=np.int64), np.arange(100, 140, dtype=np.int32)):
        a, b = mine.sample(seeds), ref.sample(seeds)  # the rng advances alike
        pairs = [(a.seeds, b.seeds), (a.input_nodes, b.input_nodes)]
        assert len(a.blocks) == len(b.blocks) == 2
        for x, y in zip(a.blocks, b.blocks):
            pairs += [(getattr(x, f.name), getattr(y, f.name))
                      for f in dataclasses.fields(x)]
        for x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
