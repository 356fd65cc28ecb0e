"""Port parity, recsys: ``repro_torch.models.recsys`` (the embedding bags and
DeepFM), ``convert.recsys_params_from_numpy``, the recsys bundles of
``launch.steps`` and ``data.synthetic``, against the JAX package on the CPU.

Parameters are the JAX package's own (``init_deepfm``,
``init_embedding_tables``), carried across by ``repro_torch.convert``;
ids are drawn with numpy from seeds.  The ragged bag runs the
``segment_sum`` autograd entry's plain version here, the CUDA kernel's
oracle on a card.

Tolerances: embedding bags ``rtol=1e-6`` (a bag of one to six float32
rows); retrieval scores ``rtol=1e-6, atol=1e-6`` (a mean of 6 rows dotted
over 8 columns; a score near 0 loses digits, 1.3e-7 measured); DeepFM
logits, scores and loss ``rtol=1e-5, atol=1e-6`` (the MLP's float32
products in another order).
Retrieval's top ids and the graph batch's edges are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.data.synthetic import graph_batch as jax_graph_batch
from repro.dist.sharding import recsys_param_specs as jax_recsys_specs
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_bundle as jax_build_bundle
from repro.models.recsys.deepfm import deepfm_logits as jax_deepfm_logits
from repro.models.recsys.deepfm import deepfm_loss as jax_deepfm_loss
from repro.models.recsys.deepfm import init_deepfm
from repro.models.recsys.deepfm import retrieval_scores as jax_retrieval_scores
from repro.models.recsys.embedding import embedding_bag as jax_embedding_bag
from repro.models.recsys.embedding import embedding_bag_segment as jax_embedding_bag_segment
from repro.models.recsys.embedding import init_embedding_tables as jax_init_tables
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.data.synthetic import InputSpec, graph_batch, make_batch
from repro_torch.dist.sharding import recsys_param_specs
from repro_torch.launch.steps import build_bundle
from repro_torch.models.recsys import (
    DeepFM,
    deepfm_logits,
    deepfm_loss,
    embedding_bag,
    embedding_bag_segment,
    init_embedding_tables,
    retrieval_scores,
)

KEY = jax.random.PRNGKey(0)
BAG_RTOL, SCORE_ATOL, LOGIT_RTOL, LOGIT_ATOL = 1e-6, 1e-6, 1e-5, 1e-6


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _deepfm():
    jcfg = jax_reduced_config(JAX_ARCHS["deepfm"])
    cfg = reduced_config(ARCHS["deepfm"])
    params = init_deepfm(KEY, jcfg)
    model = recsys_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model


def _ids(cfg, b: int, seed: int, hot: int | None = None) -> np.ndarray:
    shape = (b, cfg.n_sparse, cfg.multi_hot if hot is None else hot)
    return np.random.default_rng(seed).integers(0, cfg.vocab_per_field, shape).astype(np.int32)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False), ("sum", True)])
def test_embedding_bag_matches_jax(mode, weighted):
    tables = jax_init_tables(KEY, 3, 50, 8)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (4, 3, 2)).astype(np.int32)
    w = rng.random((4, 3, 2)).astype(np.float32) if weighted else None
    j = jax_embedding_bag(tables, jnp.asarray(ids), mode=mode,
                          weights=None if w is None else jnp.asarray(w))
    out = embedding_bag(T(tables), T(ids), mode=mode, weights=None if w is None else T(w))
    assert out.shape == (4, 3, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=BAG_RTOL)
    t = np.asarray(tables)
    manual = t[np.arange(3)[None, :, None], ids] * (1.0 if w is None else w[..., None])
    manual = manual.sum(2) if mode == "sum" else manual.mean(2)
    np.testing.assert_allclose(out.numpy(), manual, rtol=BAG_RTOL)
    with pytest.raises(ValueError):
        embedding_bag(T(tables), T(ids), mode="max")


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted-bags", "shuffled-bags"])
def test_embedding_bag_segment_ragged_matches_jax(shuffle):
    """Bags of 0 to 6 ids (bag 3 empty, so a zero row), as
    ``test_archs_recsys``'s ragged case but wider; ids in any order."""
    table = np.random.default_rng(2).standard_normal((30, 4)).astype(np.float32)
    lengths = np.array([2, 3, 1, 0, 6, 4])
    bag_ids = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    flat_ids = np.random.default_rng(3).integers(0, 30, bag_ids.shape[0]).astype(np.int32)
    if shuffle:
        perm = np.random.default_rng(4).permutation(bag_ids.shape[0])
        bag_ids, flat_ids = bag_ids[perm], flat_ids[perm]
    j = jax_embedding_bag_segment(jnp.asarray(table), jnp.asarray(flat_ids),
                                  jnp.asarray(bag_ids), len(lengths))
    out = embedding_bag_segment(T(table), T(flat_ids), T(bag_ids), len(lengths))
    assert out.dtype == torch.float32 and out.shape == (6, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=BAG_RTOL, atol=1e-7)
    assert (out[3] == 0).all()
    np.testing.assert_allclose(out[1].numpy(), table[flat_ids[bag_ids == 1]].sum(0), rtol=1e-6)
    # the autograd entry: each table row's gradient counts its uses
    tt = T(table).requires_grad_()
    embedding_bag_segment(tt, T(flat_ids), T(bag_ids), len(lengths)).sum().backward()
    np.testing.assert_array_equal(tt.grad[:, 0].numpy(),
                                  np.bincount(flat_ids, minlength=30).astype(np.float32))


def test_fm_identity():
    """FM sum-square trick == explicit pairwise dot sum, on the port."""
    _, cfg, _, model = _deepfm()
    emb = embedding_bag(model.tables.detach(), T(_ids(cfg, 8, 5))).numpy().astype(np.float64)
    explicit = np.zeros(8)
    for b in range(8):
        for i in range(cfg.n_sparse):
            for j in range(i + 1, cfg.n_sparse):
                explicit[b] += emb[b, i] @ emb[b, j]
    s = emb.sum(1)
    trick = 0.5 * ((s * s).sum(-1) - (emb * emb).sum(-1).sum(-1))
    np.testing.assert_allclose(trick, explicit, rtol=1e-9)


@pytest.mark.parametrize("hot", [1, 3])
def test_deepfm_logits_and_loss_match_jax(hot):
    jcfg, cfg, params, model = _deepfm()
    ids = _ids(cfg, 64, 6, hot)
    labels = (np.random.default_rng(7).random(64) < 0.3).astype(np.float32)
    j_logits = np.asarray(jax_deepfm_logits(params, jcfg, jnp.asarray(ids)))
    j_loss = float(jax_deepfm_loss(params, jcfg, jnp.asarray(ids), jnp.asarray(labels)))
    with torch.inference_mode():
        logits = deepfm_logits(model, T(ids))
        loss = deepfm_loss(model, T(ids), T(labels))
    assert logits.shape == (64,)
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(loss), j_loss, rtol=LOGIT_RTOL)
    # the stable form: no overflow where every logit is far from 0
    with torch.no_grad():
        model.bias.fill_(200.0)
        far = deepfm_loss(model, T(ids), torch.zeros(64))
        mean_logit = float(deepfm_logits(model, T(ids)).mean())
    assert torch.isfinite(far) and float(far) == pytest.approx(mean_logit, rel=1e-6)


def test_retrieval_scores_match_jax():
    jcfg, cfg, params, model = _deepfm()
    q = _ids(cfg, 2, 8)
    cands = np.random.default_rng(9).standard_normal((1000, cfg.embed_dim)).astype(np.float32)
    j = np.asarray(jax_retrieval_scores(params, jcfg, jnp.asarray(q), jnp.asarray(cands)))
    with torch.inference_mode():
        s = retrieval_scores(model, T(q), T(cands))
    assert s.shape == (2, 1000)
    np.testing.assert_allclose(s.numpy(), j, rtol=BAG_RTOL, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh()


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk", "retrieval_cand"])
def test_recsys_steps_match_jax(shape, host_mesh):
    """The serve step's sigmoid scores and the retrieval step's top 8 (ids
    exactly) against the JAX bundles' step functions on the same parameters
    and inputs."""
    jcfg, cfg, params, model = _deepfm()
    jb = jax_build_bundle("deepfm", shape, host_mesh, reduced=True)
    tb = build_bundle("deepfm", shape, reduced=True, device="cpu")
    assert {k: v.shape for k, v in tb.abstract_inputs.items()} == {
        k: v.shape for k, v in jb.abstract_inputs.items()}
    assert tb.input_bounds == jb.input_bounds
    ids = _ids(cfg, 8, 10)
    batch = {"ids": ids}
    if shape == "retrieval_cand":
        batch["candidates"] = np.random.default_rng(11).standard_normal(
            (4096, cfg.embed_dim)).astype(np.float32)
    j_out = jb.step_fn({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    out = tb.step_fn({"params": model}, {k: T(v) for k, v in batch.items()})
    assert set(out) == set(j_out)
    if shape == "retrieval_cand":
        np.testing.assert_array_equal(out["top_ids"].numpy(), np.asarray(j_out["top_ids"]))
        np.testing.assert_allclose(out["top_scores"].numpy(), np.asarray(j_out["top_scores"]),
                                   rtol=BAG_RTOL, atol=SCORE_ATOL)
    else:
        np.testing.assert_allclose(out["scores"].numpy(), np.asarray(j_out["scores"]),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_recsys_params_from_numpy_checks_every_leaf_and_shards_the_tables():
    jcfg, cfg, params, model = _deepfm()
    tree = jax.tree.map(np.asarray, params)
    np.testing.assert_array_equal(model.mlp.w[1].detach().numpy(), tree["mlp"]["w"][1])
    with pytest.raises(KeyError, match="bias"):
        recsys_params_from_numpy({k: v for k, v in tree.items() if k != "bias"}, cfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="tables"):
        recsys_params_from_numpy(dict(tree, tables=tree["tables"][:, :10]), cfg, device="cpu")
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(jax_recsys_specs(params))[0]
    for path, spec in flat:
        want[".".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)] = tuple(spec)
    assert recsys_param_specs(model) == want
    assert want["tables"] == (None, "model", None)


def test_deepfm_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeepFM(reduced_config(ARCHS["deepfm"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch({"ids": InputSpec((2, 3, 1), torch.int32)}, seed=0, step=0)


def test_init_embedding_tables_scale_and_device():
    gen = torch.Generator().manual_seed(0)
    t = init_embedding_tables(gen, 2, 5000, 16)
    assert t.shape == (2, 5000, 16) and t.dtype == torch.float32
    assert float(t.std()) == pytest.approx(0.25, rel=0.02)


def test_synthetic_batches_follow_the_reference_recipe():
    """``make_batch``: shapes, dtypes and bounds as the reference draws them,
    a pure function of (seed, step); ``graph_batch``: the reference's numpy
    edges, equal."""
    specs = {
        "tokens": InputSpec((3, 9), torch.int32),
        "ids": InputSpec((4, 6, 1), torch.int32),
        "labels": InputSpec((4,), torch.float32),
        "pos": InputSpec((), torch.int32),
        "edge_mask": InputSpec((5,), torch.bool),
        "x": InputSpec((5, 2), torch.float32),
    }
    bounds = {"tokens": 50, "ids": 7}
    a = make_batch(specs, seed=3, step=2, bounds=bounds, device="cpu")
    b = make_batch(specs, seed=3, step=2, bounds=bounds, device="cpu")
    for name, spec in specs.items():
        assert tuple(a[name].shape) == spec.shape and a[name].dtype == spec.dtype
        assert torch.equal(a[name], b[name])
    assert int(a["tokens"].max()) < 50 and int(a["ids"].max()) < 7
    steps = (a["tokens"][:, 1:] - a["tokens"][:, :-1]) % 50
    assert (steps == steps[:, :1]).all()  # per-row arithmetic progressions
    assert torch.equal(a["labels"], (a["ids"][:, 0, 0] % 2).float())
    assert int(a["pos"]) == 0 and bool(a["edge_mask"].all())
    assert not torch.equal(a["tokens"], make_batch(specs, seed=3, step=3, bounds=bounds,
                                                   device="cpu")["tokens"])

    gspecs = {"edge_src": InputSpec((64,), torch.int32), "edge_dst": InputSpec((64,), torch.int32),
              "trip_kj": InputSpec((32,), torch.int32), "trip_ji": InputSpec((32,), torch.int32)}
    jspecs = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in gspecs.items()}
    g = graph_batch(gspecs, seed=5, step=1, n_nodes=40, device="cpu")
    jg = jax_graph_batch(jspecs, seed=5, step=1, n_nodes=40)
    for name in gspecs:
        np.testing.assert_array_equal(g[name].numpy(), np.asarray(jg[name]))
