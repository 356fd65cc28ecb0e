#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the paper's pipeline once on one NVIDIA card, through the port's own
entry points, at the size of the paper's LiveJournal workload (LIVJ/8P):

  1. device  -- the card's name and power limit; the four kernels' builds,
                one ``nvcc`` each, all started together.
  2. segment_sum -- ``sorted_segment_sum`` at ogbn-products' full size
                (N = 2,449,029, E = 61,859,140, D = 128, float32), ids
                uniform and power-law (zipf 1.5); launch counts set to 0
                just before and read just after (each call must launch
                ``len(segment_levels(E, D))`` levels).  Then the gnn path's
                shapes, each call counted the same way: PNA's degrees
                [E, 1] and message [E, 75] (float32 and bfloat16) at that
                size, a MeshGraphNet batch [168,960, 128] and MACE's
                [8,192, 1,152].  Each held per segment against a float64
                ``index_add_`` within 1e-6 of the segment's sum of |vals|,
                then small and degenerate cases (a view one row into its
                tensor among them) against the plain version; timed beside
                its bound and ``index_add_``.
  3. flash_attention -- ``flash_attention`` on one Mixtral-8x22B attention
                layer at a 32k prefill (B=1, S=32768, H=48, Hk=8, d=128,
                causal, window 4096, bfloat16) and a causal 8k case (H=32,
                Hk=8); launch counts as above, and the TMA/wgmma kernel
                (``"bfloat16-wgmma"``) must have run.  Held against the
                chunked plain version on the first, a middle and the last
                512 rows, at 2e-2 and at a bound scaled to each row's size
                (a window 64 keys short must fail that bound), then small
                cases (ragged S among them), each naming the kernel it
                took; timed beside its bound and SDPA.
  4. lm      -- the LM serving path (``launch.steps`` prefill and decode
                bundles over ``models.transformer``), each model built from
                --seed in bfloat16 at its published widths (its build timed
                and its peak read): TinyLlama-1.1B (22 layers), Mixtral-8x22B
                cut to 2 of its 56 layers (a window of 4,096, MoE top-2),
                Mistral-NeMo-12B and Granite-3-8B (40 layers each) and
                DeepSeek-V3 cut to 4 of its 61 layers (its 3 dense layers
                and 1 MoE layer of 256 experts top-8; MLA, MTP).  One
                32,768-token prompt (prefill_32k's length, batch cut from 32
                to 1) through the prefill step, with the flash launch counts
                at 0 just before: every GQA layer must launch the TMA/wgmma
                kernel once, an MLA layer none; timed (TinyLlama and Mixtral:
                median of 3; the others once, after the counted call) and
                its peak and its MoE layers' dropped pairs read.  Held:
                layer 0's GQA attention, kernel against the plain version on
                three row blocks (as phase 3, with a window 64 keys short
                that must fail; DeepSeek-V3's plain MLA layer is timed); the
                whole model's last-position logits at S = 4,096, ``cuda``
                against ``torch``, in float32 within 1e-3 of their rms (a
                window 64 keys short must fail; DeepSeek-V3's reported: both
                backends run the same plain MLA), and TinyLlama's bfloat16
                logits within 0.25 of their rms (the short window must fail
                too; the others' bfloat16 distance is reported); decode
                replay against the forward at S = 64 in float32 within 1e-3
                of the logits' rms (a replay one cache slot late must fail),
                the float32 model's build timed and its peak read.  The
                decode step at 8 sequences (cut from 128) against a
                32,768-slot cache, 16 greedy tokens timed (all but Mixtral).
                DeepSeek-V3's loss with its MTP block at 4,096 tokens
                (finite; each MoE layer's loads sum to 1 within 1e-6).  Then
                ``serve_batch`` at its reduced config.
  5. recsys  -- DeepFM at its published config (39 fields x 1,000,000 rows
                x 10, float32): serve_bulk's scores for 262,144 requests and
                retrieval_cand's top 100 of 1,000,000 candidates, each held
                on the host in float64 and timed; then
                ``embedding_bag_segment`` over one table, 262,144 bags of 1
                to 40 ids, on the segment-sum kernel at D = 10 (counted from
                0), held per bag against float64 within 1e-6 of its sum of
                |rows| and timed beside its bound and ``index_add_``.
  6. train   -- the training stack (``launch.train``, ``launch.steps``'
                train kinds, ``optim``, ``ckpt``), each model at its
                published config: TinyLlama-1.1B's train_4k (22 layers, d
                2048, bfloat16, remat on, S = 4,096, the global batch cut
                from 256 to 4) for 2 steps from --seed, timed by CUDA
                events, its peak read and one more step profiled; gated on
                step 1 against the same model in float32 on the ``torch``
                backend (the loss, the gradient norm and attention's
                gradient norm, read off the gradients the step hands to
                AdamW), a control with attention's gradient cut must fail;
                no flash launch (the kernel has no backward).  MeshGraphNet
                (15 layers, d 128) on minibatch_lg as the bundle sizes it
                (169,984 nodes, 168,960 edges, 602 features) for 10 steps
                through ``train()``, checkpointed every 5, its segment-sum
                launches counted from 0 (every sum and every gather's
                gradient); a run that crashes at step 8 and one that
                resumes from step 5 must equal the straight run bit for
                bit; the same steps twice with plain ``index_select``
                gathers report how many tensors their atomic backward
                moves.  DeepFM's train_batch (65,536 rows, 39 x 1 M x 10) for
                5 steps.  PNA at ogb_products is reckoned, not run: its
                backward keeps more than the card holds; so is each rank's
                share on R ranks of the flattened axis, and the smallest R
                whose share fits the card.
  7. train_dp -- data-parallel training (``launch.mesh.make_host_mesh``'s
                ``(data, model = 1)`` mesh, the train bundles' ``mesh=``,
                ``train()`` inside a rank) on 2 ranks that share the card
                over gloo, every case in one ``run_ranks`` launch: TinyLlama
                as the train phase runs it (the global batch of 4, 2 rows a
                rank, the same seed and batches; its parameters and moments
                FSDP-sharded over the 2 ranks) for 1 step, its loss and
                gradient norm within 1e-5 and 1e-4 of the train phase's
                one-rank step 1 (a control, rank 0's gradient norm before
                the mean, must fail); DeepFM's train_batch at its
                published config through ``train()``, 3 steps, each held the
                same way to the train phase's, every rank's state equal bit
                for bit after the steps (per-tensor digests: DeepFM's state
                gathered whole; TinyLlama's FSDP shards are not gathered,
                11 GB through gloo, but each rank's copy of the leaves the
                data axis leaves whole, the norms and their moments, and
                the step count); step wall,
                collective calls, bytes and seconds, their share, peak
                device bytes per rank.  Then the trainer's restart across
                rank counts at DeepSeek-V3's reduced config: 4 steps
                checkpointed every 2 on 2 ranks; a crash at step 3 and its
                resume equal that run bit for bit; its last checkpoint
                resumed here on 1 rank restores the 2-rank state bit for bit
                and its 2 more losses stay within 1e-3 of the 2 ranks'.  No
                kernel is new here: the LM train step takes the plain
                attention (the flash kernel has no backward; 0 launches)
                and DeepFM's dense bags are gathers.
     model_axis -- the same launch's ranks as a ``(data = 1, model = 2)``
                mesh (``launch.mesh.make_mesh``): every parameter split by
                the reference's rule tables over ``model``.  TinyLlama's
                train_4k as above for 1 step, held to the one-rank step 1
                within 1e-4 and 2.5e-3 (bfloat16 partial sums; the control:
                rank 0's gradient norm of its own shards; no whole-state
                digest, whose 11 GB gather through gloo takes 11 s);
                TinyLlama's (22 layers) and Mixtral's (2 of 56
                layers) prefill_32k, each rank on its own heads on the flash
                kernel (TinyLlama 16 query and 2 KV heads a rank, Mixtral 24
                and 4 and its 8 experts 4 a rank), the launches counted from
                0 on each rank (one ``bfloat16-wgmma`` a layer), the last
                position's logits within 0.25 of the rms of the lm phase's
                one-rank logits; DeepFM's train_batch through
                ``train(model=2)``, its tables' vocab rows split, every step
                held to the one-rank step; a ``(1, 2)`` checkpoint of
                DeepSeek-V3's reduced config restored here on one rank bit
                for bit.  The TinyLlama train step's and each prefill's
                collectives, per axis and op, calls and bytes, must equal
                ``launch.dryrun.derived_collectives``'s count.
     serve_mesh -- the same launch's ranks serving (``launch.steps``'
                decode, serve and retrieval bundles on a mesh):
                TinyLlama's decode_32k on ``(1, 2)`` at its published
                widths as the lm phase runs it (8 sequences, a 32,768-slot
                cache of seeded entries split in time, 16,384 slots a rank,
                each rank on its 16 query and 2 KV heads), 17 steps
                teacher-forced with the lm phase's tokens, each step's
                logits within 1.0 of the rms of the lm phase's one-rank
                logits at the same positions (about 4x the largest
                distance measured, bfloat16 rounding on both paths), then
                the first 4 steps with the model and cache cast to float32
                within 1e-4 of the one-rank float32 logits (each bound's
                control, the last step again with the split-KV partials
                left unmerged, must fail it); DeepFM's serve_bulk (262,144 requests) on ``(2, 1)``
                and ``(1, 2)`` and retrieval_cand on ``(2, 1)`` (500,000
                candidates a rank, top 100) against the recsys phase's
                one-rank scores (1e-5) and top ids (equal); the dry run's
                checking half, ``launch.dryrun.cell_on_rank`` on
                TinyLlama's prefill_32k cell at its reduced config on the
                same ``(1, 2)`` mesh, each rank's flash launches counted
                from 0 (one a layer).  Every step's collectives equal the
                derived count.
     gnn_ranks -- the same launch's ranks training GNNs on the flattened
                axis (``launch.steps``: the graph batch split over every
                rank, message passing on each rank's edges and node block,
                the replicated parameters' partial gradients summed), one
                step each at the published widths: MeshGraphNet
                minibatch_lg (15 x 128; N = 169,984, E = 168,960) on
                ``(2, 1)`` and PNA minibatch_lg (4 x 75, d_feat 602) on
                ``(1, 2)``, each against the one-rank step the parent takes
                from the same seeded state and batch (loss 1e-5, gnorm
                1e-4), its control (the partial aggregates left unreduced)
                outside that bound, every rank's segment-sum launches > 0
                and its collectives equal to the derived count; each rank's
                step time, collectives, share and peak bytes printed.  Then
                the ``dryrun`` line: ``launch.dryrun`` reckons every cell
                (the GNN cells too) at both production meshes on the host
                (no card work), each cell's state bytes a rank beside this
                card's memory (not a gate).
  8. graph   -- ``rmat_graph(22, 8, seed=42)`` (about 4.2 M vertices and
                68 M directed edges, SNAP soc-LiveJournal1's size) split by
                ``bfs_grow_partition(..., 8, seed=1)``; host build times.
  9. gnn     -- the GNN stack (``repro_torch.models.gnn``), every segment
                sum on the kernel, each model's launches counted from 0:
                PNA at its full config (4 layers, d 75, 4 aggregators x 3
                scalers) full-batch at ogbn-products' size (N = 2,449,029,
                E = 61,859,140 uniform edges, d_in 100, 64 classes) under
                ``inference_mode`` on ``cuda`` and on ``torch`` (outputs
                within 2e-4), its forward timed, profiled and its peak
                read, and the kernel held and timed at its [E, 75] message;
                PNA's grads at full_graph_sm's size (2,708 nodes, 10,556
                edges, 1,433 features) against the plain version's; MACE
                and DimeNet at their full configs on 128 molecules of 30
                atoms and 64 edges (256 triplets each), ``cuda`` against
                ``torch`` and invariant under two rotations; MeshGraphNet
                (15 layers, d 128) on one minibatch_lg batch (1,024 seeds,
                fanouts 15 and 10, 602 features) sampled from the graph of
                phase 8; and halo PNA on 2 ranks sharing the card over
                gloo, on a scale-16 R-MAT graph split in two, against the
                dense forward, with one ``all_to_all`` a layer.
  10. segment_sum_livj -- ``sorted_segment_sum`` over that graph's sorted
                destinations (an R-MAT in-degree spread, D = 128), held and
                timed as in phase 2.
  11. kernel  -- the CUDA relax kernel (every template instantiation the
                main path runs) held against its plain PyTorch version at the
                main path's shapes (the local and the remote layout) and at
                the degenerate shapes (no edges, n < 8, one edge), and
                float32 min also at the elastic path's S=1 and the serving
                path's S=8 over both layouts: min bit-exact, sum within
                rtol=1e-5, atol=1e-9.  Times by CUDA
                events, one call at a time and back to back, beside the
                bound and one ``scatter_reduce`` call.  Then
                ``part_count``: the partition counters' kernel at the
                benchmark's batch of 16 rows over this graph, the closure's
                weightings (local degree, ones) and the exchange's (remote
                degree), at a sparse and an all-true frontier, bit for bit
                against the plain version and timed beside its bound and one
                ``index_add_`` call.  Then
                ``relax_phases``: a diagnosis build of the kernel
                (``RELAX_PHASE_CLOCKS``) splits a block's cycles by phase.
  12. oracle  -- BFS, SSSP, WCC and PageRank on a small graph on the card,
                held against the port's numpy oracles.
  13. slice   -- the main path: BFS from 4 sources, WCC and 20 PageRank
                iterations through ``bsp.run_program`` on the ``cuda``
                backend, with the kernel's launch counts set to 0 just
                before and read just after.  Then the same runs on the
                ``torch`` backend on the same card: state bit-identical for
                BFS and WCC, allclose for PageRank, traces exact.  BFS
                source 0 is held against the host BFS ``_bfs_hops``.
  14. pipeline -- the BFS trace becomes the time function A, scaled to
                LIVJ's T_Min of 21 s; every placement strategy is billed at
                delta = 60 s; ``predict_time_function`` gives the
                metagraph's a-priori plan.
  15. elastic -- the plan executed: ``ElasticBSPExecutor`` runs BFS from
                vertex 0 on LIVJ/8P, 8 supersteps per window, once per
                placement strategy, each planned from the metagraph
                prediction (in the trace's seconds) and re-planned online
                with it as the sketch, plus one FFD run planned from the
                prediction's first 3 supersteps only, which must re-plan;
                launch counts set to 0 just before and read just after.
                Held: state bit-identical to the slice's BFS row; the same
                runs on the ``torch`` backend give the same
                ``ExecutionReport``; one-superstep windows the same state and
                tau with one bulk pull per superstep (+1).  Then a run with
                4,096 seeded edge inserts merged at superstep 4, held against
                ``bsp.run_program`` and the host BFS on the mutated graph
                (which must hold 4,096 more edges), and the
                ``repartition=`` variant (on a cut graph where one
                repartition pass over LIVJ/8P would take over 30 s), which
                must move vertices.
  16. serve  -- ``TraversalService`` answers 16 BFS queries (8 rows a
                batch, 8 supersteps a window): first all at t = 0 on all 8
                VMs, which gives the highest rate mu it sustains, then Poisson
                arrivals at 0.25 mu and 0.9 mu, elastic and static; launch
                counts as above.  Held: every query accounted for, elastic
                no dearer than static, and at 0.9 mu the ``cuda`` and
                ``torch`` backends' reports identical and every completed
                query's state row too, the first 2 also equal to the host
                BFS.
  17. profile -- one more BFS traversal under ``torch.profiler``: the
                card's busy share, the kernels that take its time, and the
                relax reduction's three kernels (partition, reduction,
                fix-up) found by name.
  18. relax_entries -- the two min-only entries (``bfs_relax_csr``,
                ``bfs_relax``) at S=1 over the local edges, each against the
                ``torch`` backend, timed beside the kernel alone.
  19. mesh   -- the multi-GPU engine (``repro_torch.dist``): LIVJ/8P on D = 8
                ranks (one partition each) and D = 2 (four each), processes
                that share the one card over gloo (NCCL refuses two ranks on
                one card), which copies the CUDA payloads through the host.
                The parent shares the graph and its edge layout as mapped
                files; each rank builds only its own block of the mesh
                layout.  Every rank runs BFS from the slice's 4 sources, WCC
                and PageRank through ``TraversalEngine.run``, with its launch
                counts at 0 just before and read just after, and at D = 8 a
                BFS with the hub mirrored.  Held: state and ``[S, m, P]``
                counters equal to the dense engine's on the card (PageRank
                within rtol 1e-5), ``wire_msgs`` at most the active remote
                edges in every superstep and no more mirrored, every
                superstep's collectives equal to the program's signature,
                the kernel launched on every rank that holds edges, gloo
                taking CUDA tensors in all four collectives.  Then, in the
                same D = 8 launch, ``ElasticBSPExecutor`` with
                ``relayout=True`` (one superstep a window) under the FFD
                plan of a scale-17 R-MAT graph shared beside LIVJ (a depth
                cut: at LIVJ's size its re-layouts took 33-41 s): its report
                equal to the dense executor's on that graph apart from the
                physical ledger, shards moved between ranks, re-layouts
                made, residency on the plan.  Also the relax kernel at the
                hub rank's D = 8 planes.
  20. analysis -- the port's analysis layer (``repro_torch.analysis``) on
                the card: every program on both backends over the small
                audit graph (``rmat_graph(6, 4)``, 5 parts), each window's
                host reads and transfers held to the engine's counters and
                the ``cuda`` backend to its launches; one LIVJ/8P BFS window
                (8 supersteps, the slice's sources) whose reads plus
                transfers must equal the synchronizing calls that
                ``set_sync_debug_mode("warn")`` reports in it; the mesh
                audit on 2 ranks sharing the card (each program, unmirrored
                and mirrored, both ranks' collective logs equal and each
                superstep's the declared signature; the relayout sweep);
                relax, segment sum and flash launched into poisoned memory
                against their plain versions; and two controls that must be
                flagged (one extra ``.item()`` in a window, a wrapper that
                leaves rows unwritten).  Any finding fails the run.

Each phase prints one JSON line, with its host-clock ``phase_seconds``.
Then come the ``{"kernels": [...]}``
line, the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero.  Without CUDA it exits non-zero at once and prints no
result.

    python3 chip_smoke.py                    # the full LIVJ/8P size
    python3 chip_smoke.py --scale 16         # a quick run: a smaller graph,
                                             # fewer edges and a shorter S
    python3 chip_smoke.py --out smoke_report.json    # also keep the full report
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import trace_audit  # noqa: E402
from repro_torch.analysis.findings import render as render_findings  # noqa: E402
from repro_torch.analysis.fixtures import ALL_FIXTURES as ANALYSIS_FIXTURES  # noqa: E402
from repro_torch.core import STRATEGIES, BillingModel, TimeFunction, evaluate  # noqa: E402
from repro_torch.core.elastic import ElasticBSPExecutor  # noqa: E402
from repro_torch.core.metagraph import predict_time_function  # noqa: E402
from repro_torch.core.repartition import (  # noqa: E402
    RepartitionConfig,
    partition_penalty,
)
from repro_torch.core.placement import device_of_vm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.configs.base import GRAPH_SHAPES  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    load_shared_graph,
    partition_mesh,
    run_ranks,
    share_graph,
)
from repro_torch.dist.halo import build_halo_plan, scatter_nodes  # noqa: E402
from repro_torch.graph import EdgeDeltaBuffer, bsp  # noqa: E402
from repro_torch.graph.config import EngineConfig  # noqa: E402
from repro_torch.graph.generators import rmat_graph, weighted  # noqa: E402
from repro_torch.graph.partition import (  # noqa: E402
    _bfs_hops,
    bfs_grow_partition,
    contiguous_device_map,
    mesh_rank_layout,
    partitioned_edge_layout,
)
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402
from repro_torch.graph.program import (  # noqa: E402
    BfsProgram,
    PageRankProgram,
    SsspProgram,
    WccProgram,
)
from repro_torch.graph.traversal import (  # noqa: E402
    _device_arrays,
    get_engine,
    reference_bfs,
    reference_pagerank,
    reference_sssp,
    reference_wcc,
)
from repro_torch.kernels.bfs_relax import ops as relax_ops  # noqa: E402
from repro_torch.kernels.bfs_relax.kernel import (  # noqa: E402
    VARIANTS,
    RelaxKernel,
    relax_rowptr,
    tile_count,
)
from repro_torch.kernels.bfs_relax.ops import (  # noqa: E402
    _identity_scalar,
    layout_edges_on_device,
    layout_index_on_device,
)
from repro_torch.kernels.bfs_relax.ref import relax_reference  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_rows,
    bf16_tolerance_ratio,
    flash_attention,
    flash_fwd,
    reference_attention,
)
from repro_torch.kernels.flash_attention.kernel import variant_for  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    reference_segment_sum,
    segment_sum,
    segment_sum_sorted,
    sorted_segment_sum,
)
from repro_torch.kernels.segment_sum.kernel import segment_levels  # noqa: E402
from repro_torch.kernels.part_count import part_count, part_counts_reference  # noqa: E402
from repro_torch.ckpt import latest_step  # noqa: E402
from repro_torch.data.synthetic import InputSpec, graph_batch, make_batch  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch.steps import build_bundle  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.dist.sharding import shard_of  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    InjectedCrash,
    state_digests,
    state_tree,
    tensor_digest,
    train,
)
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models.attention import gqa_attend, gqa_qkv, mla_forward  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.moe import _capacity, _n_groups, moe_ffn_groups, route  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    MACE,
    PNA,
    DimeNet,
    GraphShard,
    MeshGraphNet,
    SortedEdges,
    build_triplets,
    e3,
    sort_edges,
)
from repro_torch.models.gnn.halo_pna import pna_forward_halo, rank_inputs  # noqa: E402
from repro_torch.models.recsys import (  # noqa: E402
    deepfm_logits,
    embedding_bag_segment,
    retrieval_scores,
)
from repro_torch.models.transformer import (  # noqa: E402
    Transformer,
    init_lm_cache,
    lm_decode_step,
    lm_forward,
    lm_hidden,
    lm_loss_and_stats,
)
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.models.transformer import _logits as lm_logits  # noqa: E402
from repro_torch.serve import ServiceConfig, TraversalService, poisson_trace  # noqa: E402
from repro_torch.serve.batcher import MicroBatcher  # noqa: E402

#: H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit):
#: HBM3 bandwidth, the float32 rate outside the tensor cores (the relax
#: kernel's int32 compares are counted at the same rate) and the dense
#: bfloat16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12

LIVJ_PARTS = 8
LIVJ_T_MIN_S = 21.0  # LIVJ's T_Min in the JAX package's data/workloads.py
BILLING_DELTA_S = 60.0
PAGERANK_ITERS = 20
BFS_SOURCES = 4
MAX_SUPERSTEPS = 256
#: the executor's and the service's supersteps per window (``EngineConfig``
#: and ``ServiceConfig`` defaults); the mutation run takes windows of 4, so
#: its merge at superstep 4 lands on a window boundary before the BFS ends
ELASTIC_WINDOW, MUTATION_WINDOW, MUTATION_STEP = 8, 4, 4
MUTATION_INSERTS = 4096
#: a repartition pass on the full graph is cut to this scale when its
#: projected host time (one penalty per candidate of the default pass)
#: passes REPARTITION_MAX_S.  The cut run scores this many boundary
#: vertices: the default 256 are the R-MAT hubs, whose neighbours mostly
#: share their partition, so random inserts would move none of them
REPARTITION_CUT_SCALE, REPARTITION_MAX_S, REPARTITION_CANDIDATES = 16, 30.0, 16384
#: the serving path's depth (queries a run) is cut to keep the whole script
#: near its time limit (32 until the train phase came, which took its time)
SERVE_QUERIES, SERVE_BATCH = 16, 8
#: completed serving queries whose state rows are also held against the host
#: BFS (every completed row is held against the ``torch`` backend's)
SERVE_HOST_CHECKS = 2
#: one elastic run is planned from the prediction's first supersteps only,
#: so the executed BFS outruns its plan and must re-plan
REPLAN_PLAN_STEPS = 3
SERVE_RATE_FRACTIONS = (0.25, 0.9)
#: PageRank's state on the kernel is held against a float64 power iteration
#: on the card.  A sum of positive terms adds no relative error beyond its own
#: roundings, and an iteration rounds at most 7 times in float32 (state,
#: plane, product, two kernel outputs, the update's multiply and add), so
#: after 20 iterations a vertex is within 20 * 7 * 2**-24 = 8.3e-6.
PAGERANK_RTOL, PAGERANK_ATOL = 1e-5, 1e-9

#: the mesh phase: LIVJ/8P on D ranks that share the card (gloo; NCCL
#: refuses two ranks on one card).  D = 8 is one partition per rank, the
#: paper's 8 VMs; D = 2 holds four partitions per rank
MESH_SIZES = (8, 2)
#: a launch of D ranks is killed, and the script fails, past this many seconds
MESH_LAUNCH_TIMEOUT_S = 900.0
#: the mirrored BFS run's hub threshold (cross-partition in-degree) at the
#: full size; halved with each halving of a ``--scale`` cut
MESH_MIRROR_DEGREE = 1 << 16
#: the executor run on the mesh (relayout=True, one superstep a window, so
#: the layout can follow every planned row) rebuilds every rank's own block
#: for each planned map: it runs on a graph of this scale (the full LIVJ/8P
#: size took 33-41 s of re-layouts; the cut pays for the serve_mesh phase),
#: shared beside the full graph and run in the same D = 8 launch
MESH_EXECUTOR_SCALE = 17
#: the swap run trades ranks 0 and 1's partitions after this many supersteps
MESH_SWAP_AFTER = 2
#: the analysis phase: its mesh audit's ranks (sharing the card over gloo)
#: and the supersteps of its LIVJ/8P BFS window
ANALYSIS_MESH_RANKS = 2
ANALYSIS_LIVJ_WINDOW = 8
#: the report fields of the executor's physical ledger: a mesh run may
#: differ from the dense run there and nowhere else
PHYSICAL_FIELDS = ("device_moves", "device_move_bytes", "residency", "relayouts",
                   "relayouts_skipped")

KERNEL_SOURCE = "src/repro_torch/kernels/bfs_relax/csrc/relax.cu"
KERNEL_REPLACES = "src/repro/kernels/bfs_relax/kernel.py:138"
#: the relax reduction's kernels in csrc/relax.cu, as the profiler names them
RELAX_KERNEL_SYMBOLS = ("relax_partition_kernel", "relax_rowptr_kernel", "relax_fixup_kernel")
SEG_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
SEG_REPLACES = "src/repro/kernels/segment_sum/kernel.py:61"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:91"
PART_COUNT_SOURCE = "src/repro_torch/kernels/part_count/csrc/part_count.cu"
#: no TPU kernel: the JAX package counts per edge with jax.ops.segment_sum
PART_COUNT_REPLACES = None
#: the partition counters' rows (the benchmark's batch of 16 sources) and
#: the frontier densities they are timed at: sparse, as most closure
#: iterations find it, and all-true, as PageRank's is
PART_COUNT_ROWS = 16
PART_COUNT_DENSITIES = (0.01, 1.0)
FULL_SCALE = 22

#: ogbn-products at full size (OGB's published counts): the segment sum's
#: main shape, the workload benchmarks/kernel_bench.py names.
OGBN_PRODUCTS_N, OGBN_PRODUCTS_E, SEG_D = 2_449_029, 61_859_140, 128
#: kernel against a float64 sum, per segment: |err| <= SEG_REL_TOL *
#: sum(|vals|) over the segment.  The JAX tests' 1e-4 is for segments of a
#: few terms; the power-law hub holds about 38% of all edges (23.7 M
#: terms), where any float32 order drifts far more than 1e-4 in absolute
#: terms, so the bound scales with the segment.  The kernel adds runs of at
#: most 128 terms and then those partials level by level; on an H100 at the
#: full size it stood at most 3.7e-7 of sum(|vals|) off float64 (uniform;
#: 2.4e-7 power-law), the float32 ``index_add_`` at 3.5e-7 / 2.8e-7, and
#: the bound leaves 2.7x of room over that.
SEG_REL_TOL = 1e-6
#: kernel against the plain version on the small cases (both float32)
SEG_SMALL_REL_TOL = 1e-5
#: the gnn path's own segment-sum shapes, each a row of the segment_sum
#: phase at full size: (case, E, N, D, vals dtype) -- PNA's degrees and its
#: [E, 75] message at ogbn-products' size (float32 and bfloat16; E cut with
#: --scale), a MeshGraphNet minibatch_lg batch (168,960 edges into 169,984
#: node slots, configs/base.py) and MACE's molecule batch (128 molecules,
#: 8,192 edges of 1,152 = 128 x 9 features into 3,840 atoms); ids uniform
SEG_GNN_SHAPES = (
    ("pna_degrees_d1", OGBN_PRODUCTS_E, OGBN_PRODUCTS_N, 1, torch.float32),
    ("pna_message_d75", OGBN_PRODUCTS_E, OGBN_PRODUCTS_N, 75, torch.float32),
    ("pna_message_d75_bf16", OGBN_PRODUCTS_E, OGBN_PRODUCTS_N, 75, torch.bfloat16),
    ("meshgraphnet_d128", 168_960, 169_984, 128, torch.float32),
    ("mace_d1152", 8192, 3840, 1152, torch.float32),
)
#: one Mixtral-8x22B attention layer at a 32k prefill
#: (src/repro/configs/mixtral_8x22b.py; benchmarks/kernel_bench.py:47-49
#: unsharded), and the causal 8k case with granite-3-8b's and
#: mistral-nemo-12b's heads
FLASH_MAIN = {"b": 1, "s": 32768, "h": 48, "hk": 8, "d": 128, "causal": True, "window": 4096}
FLASH_CAUSAL = {"b": 1, "s": 8192, "h": 32, "hk": 8, "d": 128, "causal": True, "window": None}
#: the JAX tests' tolerances: bfloat16 2e-2 (held in float32), float32 1e-5.
#: A bfloat16 output is also held to ``bf16_tolerance_ratio`` <= 1 (the
#: bound per element scales with its row: ``flash_attention/ref.py``), since
#: a 4096-key window's outputs are about as small as 2e-2.
FLASH_BF16_TOL, FLASH_F32_TOL = 2e-2, 1e-5
FLASH_CHECK_ROWS = 512
#: the control: the window case run with a window this many keys short
#: (half a 128-key tile) must fail the scaled bound on the rows it changes;
#: it runs where the window is shorter than S (not in a cut run)
FLASH_CONTROL_SHORT = 64
#: the lm phase: each model at its published widths (configs/*.py), built
#: from --seed in bfloat16: (arch, layers kept, or None for all).  Mixtral's
#: 141 B and DeepSeek-V3's 671 B parameters do not fit one card, so their
#: depth is cut, never a width: DeepSeek-V3 keeps its 3 dense layers and 1
#: MoE layer (and its MTP block, which the prefill does not run).
LM_MODELS = (("tinyllama-1.1b", None), ("mixtral-8x22b", 2), ("mistral-nemo-12b", None),
             ("granite-3-8b", None), ("deepseek-v3-671b", 4))
#: the models whose prefill the model_axis phase holds on ranks
#: (PREFILL_REFS); their prefill is timed as a median of 3 and profiled.
#: The others are timed once after the counted call, and of them only the
#: MLA model is profiled (its attention is plain PyTorch, no kernel)
LM_RANKED = ("tinyllama-1.1b", "mixtral-8x22b")
#: decode_32k runs for these; the first fills DECODE_REFS for serve_mesh
LM_DECODED = ("tinyllama-1.1b", "mistral-nemo-12b", "granite-3-8b", "deepseek-v3-671b")
#: DeepSeek-V3's loss with its MTP block: ``lm_loss_and_stats``'s forward at
#: train_4k's S, batch 1, bfloat16; the loss and the MTP term (the reference's
#: weight MTP_WEIGHT, models/transformer.py) finite, each MoE layer's loads
#: summing to 1 within LM_LOADS_TOL; the dropped (token, k) pairs reported
LM_MTP_S, MTP_WEIGHT, LM_LOADS_TOL = 4096, 0.3, 1e-6
#: DeepSeek-V3's MoE layer at the 32k prefill's token count, where its
#: [G, E*C, D] dispatch tensors hold more than 2**31 elements (32 x 10,240
#: x 7,168): the layer's output on seeded inputs (each token a shared
#: direction plus its own, so that popular experts overflow their capacity,
#: as the model's hidden states make them do) for the first and the last
#: dispatch group's tokens (the last group's slots lie past element 2**31),
#: against a float32 reference built expert by expert from ``route``'s kept
#: pairs and the shared expert: the rms of the difference within
#: MOE_BIG_SHARE of the reference's rms (0.0046 read on an H100 with
#: unshared inputs, about a quarter of it); the control, the same reference
#: with the dropped pairs added back, must miss it
MOE_BIG_SHARE, MOE_BIG_ELEMENTS = 0.02, 2**31
#: prefill_32k's length at batch 1 (its published batch is 32); decode_32k's
#: cache at 8 sequences (published: 128), 16 greedy tokens
LM_PREFILL_S, LM_PREFILL_BATCH = 32768, 1
LM_DECODE_BATCH, LM_DECODE_CACHE, LM_DECODE_TOKENS = 8, 32768, 16
#: the whole model's last-position logits, ``cuda`` against ``torch``, at
#: this length (the plain backend's chunked path), in float32 (the same
#: widths, float32 parameters from --seed): max |diff| <= LM_LOGIT_SHARE *
#: rms(logits), and a run with the window FLASH_CONTROL_SHORT keys short
#: must fail it.  In bfloat16 the two backends round attention differently
#: (the kernel keeps float32 scores, the plain path rounds them): the dense
#: model's (LM_BF16_GATED) bfloat16 logits are held to LM_BF16_LOGIT_SHARE *
#: rms(logits), between the sound distance (0.086 of an rms near 1 on an
#: H100) and the short window's (0.6 in float32), and the short window must
#: fail it too.  An MoE layer's top-2 choice flips on a near tie, which
#: moves a token by a whole expert, so Mixtral's bfloat16 distance is
#: reported, not gated.
LM_CHECK_S = 4096
LM_LOGIT_SHARE, LM_BF16_LOGIT_SHARE = 1e-3, 0.25
LM_BF16_GATED = ("tinyllama-1.1b",)
#: decode replay against the forward (tests/test_archs_lm.py's
#: test_decode_matches_forward at the published widths): float32, this many
#: positions, each step's logits within LM_LOGIT_SHARE * rms(the forward's
#: logits); the control, each token written one cache slot late (slot 0
#: left empty and read by every step), must fail that bound
LM_REPLAY_S = 64
#: the recsys phase: DeepFM at its published config (configs/deepfm.py:
#: 39 fields x 1,000,000 rows x 10, float32) on serve_bulk (262,144
#: requests) and retrieval_cand (1,000,000 candidates, top 100); scores
#: held on RECSYS_CHECK_ROWS rows against the same function in float64 on
#: the host within RECSYS_SCORE_TOL.  Then the ragged bag over one table:
#: RECSYS_BAGS bags of 1 to RECSYS_BAG_MAX ids (uniform), per bag within
#: SEG_REL_TOL of its sum of |rows| against float64.
RECSYS_CHECK_ROWS, RECSYS_SCORE_TOL = 4096, 1e-5
RECSYS_BAGS, RECSYS_BAG_MAX = 262_144, 40
#: the train phase.  TinyLlama-1.1B's train_4k at its published widths and
#: dtype (bfloat16, remat on, S = 4,096), the global batch cut from 256 to
#: TRAIN_LM_BATCH sequences, TRAIN_LM_STEPS steps from --seed.  The gate:
#: step 1's loss, global gradient norm and the attention projections'
#: gradient norm (every layer's wq, wk, wv; read off the gradients the step
#: hands to ``adamw_update``), against the same model's values on the same
#: batch in float32 on the ``torch`` backend (one sequence at a time, the
#: gradients averaged), each within TRAIN_GATE_RTOL of the float32 value
#: (measured 5.3e-6, 2.9e-4 and 2.9e-4 on an H100, about a tenth of each
#: bound); the control, attention with its gradient cut (q, k, v detached:
#: what a forward-only kernel would do without the entry's refusal), must
#: fail it (measured: gnorm 0.72 off, attention's 1.0).
TRAIN_LM_ARCH, TRAIN_LM_BATCH, TRAIN_LM_STEPS = "tinyllama-1.1b", 4, 2
TRAIN_GATE_RTOL = {"loss": 5e-5, "gnorm": 3e-3, "attn_gnorm": 3e-3}
#: MeshGraphNet (15 layers, d 128) on minibatch_lg as launch/steps.py sizes
#: it, TRAIN_GNN_STEPS steps with a checkpoint every TRAIN_GNN_CKPT; then a
#: run that crashes at step TRAIN_GNN_CRASH and one that resumes from its
#: checkpoint: losses and final state bit for bit those of the straight run
TRAIN_GNN = ("meshgraphnet", "minibatch_lg")
TRAIN_GNN_STEPS, TRAIN_GNN_CKPT, TRAIN_GNN_CRASH = 10, 5, 8
#: the atomic-order probe's depth (two runs with ``index_select`` gathers)
TRAIN_GNN_PROBE_STEPS = 3
#: DeepFM's train_batch at its published config
TRAIN_RECSYS_STEPS = 5
#: the train_dp phase: data-parallel training (the train bundles on the data
#: axis of ``launch.mesh.make_host_mesh``) on TRAIN_DP_RANKS ranks sharing
#: the card over gloo, every case in one launch.  TinyLlama as the train
#: phase runs it (the global batch of TRAIN_LM_BATCH sequences, so
#: TRAIN_LM_BATCH / TRAIN_DP_RANKS a rank, the same seed and batches) and
#: DeepFM's train_batch through ``train()``, TRAIN_DP_STEPS steps each:
#: TinyLlama's step 1 and DeepFM's every step held to the train phase's
#: one-rank loss and gradient norm within TRAIN_DP_RTOL (measured on an
#: H100: loss 8.8e-8 and 1.1e-7, gradient norm 1.1e-6 and 0, about a
#: hundredth of the bound); the control, rank 0's gradient norm of its own
#: rows before the mean, must fail it (measured 0.43 and 0.33).  Then
#: ``train()``'s restart across rank counts at DeepSeek-V3's reduced config
#: (the card's bfloat16): TRAIN_DP_RESTART[0] steps checkpointed every
#: TRAIN_DP_RESTART[1] on 2 ranks; a run that crashes at TRAIN_DP_RESTART[2]
#: and its resume equal it bit for bit; its last checkpoint resumed for
#: TRAIN_DP_RESTART[3] more steps on 1 rank (in this process) restores the
#: 2-rank state bit for bit, and its losses stay within
#: TRAIN_DP_RESTART_RTOL of the same steps resumed on 2 ranks (bfloat16
#: parameters updated from differently rounded gradients; measured 6.1e-8
#: and 1.1e-4).
TRAIN_DP_RANKS, TRAIN_DP_STEPS, TRAIN_DP_LM_STEPS = 2, 3, 1
TRAIN_DP_RTOL = {"loss": 1e-5, "gnorm": 1e-4}
TRAIN_DP_RESTART_RTOL = 1e-3
TRAIN_DP_RESTART_ARCH = "deepseek-v3-671b"
TRAIN_DP_RESTART = (4, 2, 3, 2)
TRAIN_DP_TIMEOUT_S = 900.0
#: the model_axis phase (in train_dp's launch): the ranks as a (data = 1,
#: model = MODEL_AXIS_RANKS) mesh; TinyLlama's train step and DeepFM's held
#: as train_dp holds them; the prefill of each of LM_MODELS as the lm phase
#: builds it (its one-rank last-position logits kept in PREFILL_REFS), each
#: rank's flash launches n_layers, the logits within LM_BF16_LOGIT_SHARE of
#: the one-rank logits' rms (both run the flash kernel on the same heads;
#: only the row-parallel sums' rounding differs).  TinyLlama's bfloat16 step
#: on the model axis rounds each row-parallel projection's two partial sums
#: before adding them, where one rank rounds their sum once: its step 1 is
#: held to MODEL_AXIS_LM_RTOL of the one-rank step, about 4x the distance
#: measured on an H100 (loss 2.1e-5, gradient norm 6.1e-4), which the
#: control (rank 0's gradient norm of its own shards; measured 0.40) must
#: fail
MODEL_AXIS_RANKS = 2
MODEL_AXIS_LM_RTOL = {"loss": 1e-4, "gnorm": 2.5e-3}
PREFILL_REFS: dict = {}
#: the serve_mesh phase (in train_dp's launch, after model_axis): the
#: serving bundles on the same 2 ranks.  TinyLlama's decode_32k on the (1,
#: 2) mesh as the lm phase runs it (LM_DECODE_BATCH sequences against a
#: LM_DECODE_CACHE-slot cache of seeded entries, split-KV: half the slots a
#: rank), teacher-forced with the lm phase's tokens: each step's logits
#: within DECODE_MESH_BF16_SHARE of the rms of the lm phase's one-rank
#: logits, and the first DECODE_F32_STEPS steps, the model and the same
#: cache cast to float32, within DECODE_MESH_F32_SHARE of the one-rank
#: float32 logits' (DECODE_REFS: arch -> (config, tokens, first position,
#: cache slots, bfloat16 logits, float32 logits)); each with its control
#: (the last step again with the partials left unmerged: each rank attends
#: its own slots alone) outside it.  Both bounds are about 4x the largest
#: distance measured on an H100 (tools/decode_probe.py gap, 8 steps): in
#: bfloat16 0.2502, which is rounding, not a defect: the one-rank bfloat16
#: logits lie as far from the float32 ones (0.200-0.238) as the split ones
#: do (0.202-0.277), and the residual stream's distance from float32 grows
#: with depth alike on both paths, 0.0055-0.0058 of its rms after one layer
#: to 0.044-0.045 after 22; in float32 the split path reads 1.8e-5-2.1e-5.
#: DeepFM's
#: serve_bulk on (2, 1) and (1, 2) and retrieval_cand on (2, 1) (half the
#: candidates a rank) against the
#: recsys phase's one-rank outputs (RECSYS_REFS): scores within
#: RECSYS_SCORE_TOL, the top ids equal.  Every case's collectives, each step,
#: equal ``launch.dryrun.derived_collectives``'s count
DECODE_MESH_BF16_SHARE, DECODE_MESH_F32_SHARE, DECODE_F32_STEPS = 1.0, 1e-4, 4
DECODE_REFS: dict = {}
RECSYS_REFS: dict = {}
#: the dry run's checking half on the card, in serve_mesh:
#: ``launch.dryrun.cell_on_rank`` on this (architecture, shape) cell at its
#: reduced config (2 layers, 4 sequences of 32 tokens) on the (1, 2) mesh;
#: every rank's collectives must equal the derived count and, on a card,
#: its flash launches (counted from 0 around the cell) one a layer
DRYRUN_CELL = ("tinyllama-1.1b", "prefill_32k")
#: the gnn_ranks phase (in train_dp's launch, after serve_mesh): GNN training
#: on the flattened axis of the same 2 ranks (``launch.steps``: the graph
#: batch split over every rank, the parameters replicated, the gradients
#: summed), one step of each case at its published config: (architecture,
#: shape, mesh as (data, model)).  Each is held to the one-rank step the
#: parent takes from the same seeded state and batch (GNN_REFS) within
#: TRAIN_DP_RTOL; its control, the same step with the partial aggregates
#: left unreduced (``GraphShard.scatter`` as the rank's own edges' sums),
#: outside it; every rank's segment-sum launches > 0 on a card and its
#: collectives equal to ``launch.dryrun.derived_collectives``
GNN_RANKS = (("meshgraphnet", "minibatch_lg", (2, 1)), ("pna", "minibatch_lg", (1, 2)))
GNN_REFS: dict = {}
#: the template instantiations the main path runs, and the program each
#: serves there: (variant, reduce, dtype, program name)
MAIN_VARIANTS = (
    ("float32-min", "min", torch.float32, "bfs"),
    ("int32-min", "min", torch.int32, "wcc"),
    ("float32-sum", "sum", torch.float32, "pagerank"),
)
#: the gnn phase: every GNN architecture at its full published config
#: (src/repro_torch/configs/{pna,meshgraphnet,mace,dimenet}.py) on the
#: graph shapes of configs/base.py; node-classification heads are
#: launch/steps.py's 64 classes
GNN_CLASSES = 64
#: MACE and DimeNet read this many triplets a molecule (launch/steps.py)
MOL_TRIPLETS = 256
#: halo PNA: a scale-16 R-MAT graph split in two, on two ranks sharing the
#: card over gloo
HALO_SCALE, HALO_RANKS = 16, 2
#: the ``cuda`` backend against ``torch`` (the same model, only the segment
#: sums' order differs): PNA and MeshGraphNet outputs within GNN_ATOL of
#: max(1, max |out|) (tests/test_halo.py's bound, scaled for MeshGraphNet's
#: 15 residual layers); MACE and DimeNet energies within ENERGY_RTOL and
#: rotated energies within ROT_RTOL (tests/test_archs_gnn.py's), both of
#: the batch's largest |energy|: a molecule whose terms cancel to a small
#: energy keeps the absolute error of the others (on the CPU, 4e-7 of the
#: largest); halo PNA within HALO_ATOL of the dense forward on the card.
#: PNA's grads at its full config: each parameter's within GRAD_SHARE of its
#: largest |grad|.  Elementwise rtol 1e-3 / atol 1e-5 (the bound the
#: reduced config meets, tests/test_torch_{gnn,cuda}.py) does not hold here
#: between two float32 summation orders: std's sqrt(mean_sq - mean^2)
#: cancels on low-degree nodes.  The line's ``plain_order_spread_share`` is
#: how far the plain version moves with the edges in another order; the
#: runs use deterministic algorithms, so the check reads the same each run
#: (the atomic order of ``index_add_`` moved it 10x between runs); the
#: gradient of the entry itself is held exactly (``grad == up[ids]``)
GNN_ATOL, ENERGY_RTOL, ROT_RTOL, HALO_ATOL, GRAD_SHARE = 2e-4, 1e-5, 2e-5, 2e-4, 5e-3
ROTATIONS = ((0.7, (1.0, 2.0, 3.0)), (2.1, (0.0, 1.0, 0.0)))
#: the instantiation the elastic path (BFS, S=1) and the serving path (SSSP
#: on unit weights, S = SERVE_BATCH) launch; ``phase_kernels`` also holds it
#: at those two shapes over both layouts
PATH_VARIANT = "float32-min"


#: each phase's host-clock seconds, from the previous phase's line to its own
PHASE_SECONDS: dict = {}
_last_emit = [time.perf_counter()]


def _emit(phase: str, payload: dict) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[phase] = now - _last_emit[0]
    _last_emit[0] = now
    print(json.dumps({"phase": phase, "phase_seconds": PHASE_SECONDS[phase], **payload}),
          flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------


def _median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-launch times by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _once_ms(fn) -> float:
    """One call's time by CUDA events, with no warm-up: for a call the
    caller has already run at this shape."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def _back_to_back_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` calls enqueued back to back between two CUDA
    events, after one warm-up call: the host's per-call work overlaps the
    card's, so a short kernel is not charged the wait for its own launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(s: int, n: int, e: int) -> tuple[float, str]:
    """Least time on the card for one reduction: each input read once
    (cand, row_ptr, base) and each output written once, against the card's
    bandwidth; one compare or add per candidate against its peak rate."""
    nbytes = 4 * s * e + 4 * (n + 1) + 2 * 4 * s * n
    ops = s * e
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    diff = (a.double() - b.double()).abs()
    return float(torch.where(a == b, torch.zeros_like(diff), diff).max())


# -- phases ------------------------------------------------------------------


KERNELS = {"relax": relax_rowptr, "segment_sum": segment_sum_sorted, "flash_attention": flash_fwd,
           "part_count": part_count}
#: a diagnosis build of the relax kernel that records its phase clocks
#: (``RELAX_PHASE_CLOCKS`` in csrc/relax.cu); never on the main path
RELAX_PHASE_KERNEL = RelaxKernel(defines=("RELAX_PHASE_CLOCKS",))
#: the spans between relax_rowptr_kernel's phase marks, in order
RELAX_PHASES = ("prologue loads", "per-thread search", "stage source 0", "walk + warp scan",
                "block scan + first rows", "output, later sources")


def phase_device() -> dict:
    """The card, and the three kernels' builds: one ``nvcc`` per source,
    all started together."""
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        for fut in [pool.submit(k.load) for k in (*KERNELS.values(), RELAX_PHASE_KERNEL)]:
            fut.result()
    build_s = time.perf_counter() - t0
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": build_s,
        "kernel_build_s_each": {name: k.build_seconds for name, k in KERNELS.items()},
        "ptxas": {
            name: [line.strip() for line in k.build_log.splitlines()
                   if "registers" in line or "spill" in line]
            for name, k in KERNELS.items()
        },
    }


def _cut(scale: int) -> int:
    """How many halvings a ``--scale`` below the full size asks for."""
    return max(0, FULL_SCALE - scale)


def _library_ms(fn, reps: int) -> tuple[float | None, str]:
    """A yardstick's time, or None and the reason it could not run."""
    try:
        return _median_ms(fn, reps), "ran"
    except (RuntimeError, ValueError) as exc:  # the yardstick only, never a check
        torch.cuda.empty_cache()
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


# -- segment sum ---------------------------------------------------------------


def _seg_bound(e: int, n: int, d: int, val_bytes: int, id_bytes: int) -> tuple[float, str]:
    """Each value and id read once, each output written once; one add per
    value."""
    t_bytes = (val_bytes * e * d + id_bytes * e + 4 * n * d) / HBM_BYTES_PER_S * 1e3
    t_ops = e * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _seg_ids(rng, e: int, n: int, skew: str, device) -> torch.Tensor:
    """Seeded ids drawn on the host as tests/test_kernels.py draws them,
    sorted on the card, int32."""
    raw = rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e)
    ids = torch.as_tensor(raw.astype(np.int32), device=device)
    return ids.sort().values


def _seg_against_f64(out, ids, vals, n, chunk=1 << 21) -> dict:
    """The kernel's and the float32 plain version's error per segment
    against a float64 ``index_add_`` over edge chunks, as a share of the
    segment's sum of |vals|."""
    ref = torch.zeros((n, vals.shape[1]), dtype=torch.float64, device=vals.device)
    mag = torch.zeros_like(ref)
    for c0 in range(0, ids.shape[0], chunk):
        idx = ids[c0:c0 + chunk].long()
        x = vals[c0:c0 + chunk].double()
        ref.index_add_(0, idx, x)
        mag.index_add_(0, idx, x.abs_())
        del x
    plain = reference_segment_sum(ids, vals, n)
    res = {}
    for name, t in (("kernel", out), ("plain_f32", plain)):
        err = (t.double() - ref).abs_()
        excess = float((err - SEG_REL_TOL * mag).max())
        share = float((err / mag.clamp_min(1e-300)).max())
        res[name] = {"max_abs_err": float(err.max()), "max_err_over_abs_sum": share,
                     "within_tol": excess <= 0.0}
        del err
    res["kernel_vs_plain_max_abs_err"] = _max_abs_err(out, plain)
    del ref, mag, plain
    return res


def _seg_small_cases(device, seed: int) -> list[dict]:
    """Degenerate and odd shapes, held against the plain version on the
    card: per segment |err| <= SEG_SMALL_REL_TOL * sum(|vals|)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    cases = (
        # name, E, N, D, vals dtype, skew, ids dtype, sorted
        ("e0", 0, 64, 16, torch.float32, "uniform", torch.int32, True),
        ("n_lt_8", 50, 5, 16, torch.float32, "uniform", torch.int32, True),
        ("single_edge", 1, 40, 16, torch.float32, "uniform", torch.int32, True),
        ("d10", 20_000, 900, 10, torch.float32, "uniform", torch.int32, True),
        ("d33", 20_000, 900, 33, torch.float32, "powerlaw", torch.int64, True),
        ("d75", 20_000, 900, 75, torch.float32, "powerlaw", torch.int32, True),
        ("d1", 20_000, 900, 1, torch.float32, "powerlaw", torch.int32, True),
        ("bf16", 20_000, 900, 64, torch.bfloat16, "uniform", torch.int32, True),
        ("bf16_d75", 20_000, 900, 75, torch.bfloat16, "uniform", torch.int64, True),
        ("offset_view_d33", 20_000, 900, 33, torch.float32, "powerlaw", torch.int32, True),
        ("ids_out_of_range", 20_000, 900, 32, torch.float32, "out_of_range", torch.int32, True),
        ("unsorted", 20_000, 900, 32, torch.float32, "powerlaw", torch.int32, False),
        ("hub_levels", 2_000_000, 5000, 48, torch.float32, "powerlaw", torch.int32, True),
    )
    out = []
    for name, e, n, d, vdt, skew, idt, is_sorted in cases:
        if skew == "out_of_range":
            raw = np.sort(rng.integers(-7, n + 7, e))
        else:
            raw = np.sort(rng.zipf(1.5, e) % n if skew == "powerlaw" else rng.integers(0, n, e))
        ids = torch.as_tensor(raw, device=device).to(idt)
        vals = torch.randn((e, d), generator=gen, device=device).to(vdt)
        if name.startswith("offset_view"):  # views one row into their tensors: a peeled head
            ids, vals = torch.cat([ids[:1], ids])[1:], torch.cat([vals[:1], vals])[1:]
        if not is_sorted:
            perm = torch.randperm(e, generator=gen, device=device)
            ids, vals = ids[perm], vals[perm]
        got = sorted_segment_sum(ids, vals, n, assume_sorted=is_sorted)
        ref = reference_segment_sum(ids, vals, n)
        mag = reference_segment_sum(ids, vals.float().abs(), n)
        torch.cuda.synchronize()
        _check(got.shape == (n, d) and got.dtype == torch.float32,
               f"segment sum {name}: shape {tuple(got.shape)} {got.dtype}")
        err = (got - ref).abs()
        _check(bool((err <= SEG_SMALL_REL_TOL * mag).all()),
               f"segment sum {name} disagrees with the plain version (max abs err "
               f"{float(err.max()) if err.numel() else 0.0})")
        out.append({"case": name, "E": e, "N": n, "D": d, "vals": str(vdt)[6:],
                    "ids": str(idt)[6:], "max_abs_err": _max_abs_err(got, ref)})
    return out


def _seg_case(name: str, out, ids, vals, n: int) -> dict:
    """One main-shape call's output held against float64, then the entry
    point, the plain version and ``index_add_`` timed on the same inputs."""
    e, d = vals.shape
    _check(out.shape == (n, d) and out.dtype == torch.float32
           and bool(torch.isfinite(out).all()),
           f"segment sum {name}: not finite float32 [N, D]")
    held = _seg_against_f64(out, ids, vals, n)
    _check(held["kernel"]["within_tol"],
           f"segment sum {name}: kernel off float64 by more than {SEG_REL_TOL} of a "
           f"segment's sum of |vals| ({held['kernel']['max_err_over_abs_sum']})")
    del out
    largest = int(torch.bincount(ids, minlength=n).max())
    ids_long = ids.long()
    # index_add_ takes one dtype: a bfloat16 sum accumulates into bfloat16
    lib_out = torch.zeros((n, d), dtype=vals.dtype, device=vals.device)
    bound_ms, bound_by = _seg_bound(e, n, d, vals.element_size(), ids.element_size())
    lib_ms, lib_note = _library_ms(lambda: lib_out.index_add_(0, ids_long, vals), 5)
    del ids_long, lib_out
    return {
        "case": name, "E": e, "N": n, "D": d,
        "vals": str(vals.dtype)[6:], "ids": str(ids.dtype)[6:],
        "largest_segment": largest,
        "max_abs_err": held["kernel_vs_plain_max_abs_err"],
        "against_float64": held,
        "ms": _median_ms(lambda: sorted_segment_sum(ids, vals, n, assume_sorted=True), 5),
        "plain_ms": _median_ms(lambda: reference_segment_sum(ids, vals, n), 5),
        "library_ms": lib_ms, "library": f"Tensor.index_add_ ({str(vals.dtype)[6:]})",
        "library_note": lib_note,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _seg_gnn_rows(device, seed: int, scale: int) -> tuple[list[dict], int]:
    """The gnn path's shapes (``SEG_GNN_SHAPES``), one at a time: each
    entry call counted from 0 (it must launch ``len(segment_levels(E, D))``
    levels), held against float64 and timed as ``_seg_case`` does."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)
    rows, launches = [], 0
    for name, e, n, d, vdt in SEG_GNN_SHAPES:
        if e == OGBN_PRODUCTS_E:
            e >>= _cut(scale)
        ids = _seg_ids(rng, e, n, "uniform", device)
        vals = torch.randn((e, d), generator=gen, device=device).to(vdt)
        torch.cuda.synchronize()
        segment_sum_sorted.launches = 0
        out = sorted_segment_sum(ids, vals, n, assume_sorted=True)
        torch.cuda.synchronize()
        count = segment_sum_sorted.launches
        _check(count == len(segment_levels(e, d)),
               f"segment sum {name}: {count} launches, not {len(segment_levels(e, d))}")
        launches += count
        rows.append({**_seg_case(name, out, ids, vals, n), "launches": count})
        del out, ids, vals
        torch.cuda.empty_cache()
    return rows, launches


def phase_segment_sum(device, seed: int, scale: int) -> dict:
    """``sorted_segment_sum`` at ogbn-products' full size (E cut by
    ``2**(22 - scale)`` below the full scale), uniform and power-law ids;
    then the gnn path's shapes (``SEG_GNN_SHAPES``)."""
    e = OGBN_PRODUCTS_E >> _cut(scale)
    n, d = OGBN_PRODUCTS_N, SEG_D
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vals = torch.randn((e, d), generator=gen, device=device)  # 31.7 GB at full size
    rng = np.random.default_rng(seed)
    skews = ("uniform", "powerlaw")
    ids = {skew: _seg_ids(rng, e, n, skew, device) for skew in skews}
    torch.cuda.synchronize()

    # -- the entry point's calls, with the launch count at 0 just before --
    segment_sum_sorted.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = {skew: sorted_segment_sum(ids[skew], vals, n, assume_sorted=True) for skew in skews}
    torch.cuda.synchronize()
    launches = segment_sum_sorted.launches
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's calls --
    _check(launches == 2 * len(segment_levels(e, d)),
           f"sorted_segment_sum launched {launches} levels, not 2 x {segment_levels(e, d)}")

    cases = [_seg_case(skew, outs.pop(skew), ids[skew], vals, n) for skew in skews]
    del vals, ids
    torch.cuda.empty_cache()
    gnn_rows, gnn_launches = _seg_gnn_rows(device, seed, scale)
    small = _seg_small_cases(device, seed)
    torch.cuda.empty_cache()
    return {
        "shape": {"E": e, "N": n, "D": d, "dtype": "float32", "ids": "int32"},
        "cut": _cut(scale) > 0,
        "levels": segment_levels(e, d),
        "launches": launches + gnn_launches,
        "peak_device_bytes": peak,
        "rel_tol_vs_float64": SEG_REL_TOL,
        "cases": cases + gnn_rows,
        "small": small,
    }


def phase_segment_sum_livj(pg, device, seed: int) -> dict:
    """``sorted_segment_sum`` over the LIVJ graph's destinations, sorted:
    one segment per vertex, one D = 128 float32 row per edge.  The ids of
    phase 2 are synthetic; these carry an R-MAT graph's in-degree spread."""
    g = pg.graph
    n, e, d = g.n_vertices, g.n_edges, SEG_D
    ids = torch.as_tensor(g.dst.astype(np.int32), device=device).sort().values
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    vals = torch.randn((e, d), generator=gen, device=device)
    torch.cuda.synchronize()

    # -- the entry point's call, with the launch count at 0 just before --
    segment_sum_sorted.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = sorted_segment_sum(ids, vals, n, assume_sorted=True)
    torch.cuda.synchronize()
    launches = segment_sum_sorted.launches
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's call --
    _check(launches > 0, "sorted_segment_sum launched its kernel no time (LIVJ ids)")
    case = _seg_case("livj_dst", out, ids, vals, n)
    del out, ids, vals
    torch.cuda.empty_cache()
    return {
        "shape": {"E": e, "N": n, "D": d, "dtype": "float32", "ids": "int32"},
        "launches": launches,
        "peak_device_bytes": peak,
        "rel_tol_vs_float64": SEG_REL_TOL,
        "cases": [case],
    }


# -- flash attention -------------------------------------------------------


def _mask_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs inside the mask, counted row by row."""
    rows = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros_like(rows)
    hi = rows + 1 if causal else np.full_like(rows, s)
    return int((hi - lo).sum())


def _flash_bound(cfg: dict, elt: int) -> tuple[float, str, int]:
    """QK^T and PV over the pairs inside the mask (2 FLOP per multiply-add)
    at the bfloat16 tensor-core rate; q, k, v read and o written once."""
    b, s, h, hk, d = cfg["b"], cfg["s"], cfg["h"], cfg["hk"], cfg["d"]
    pairs = _mask_pairs(s, cfg["causal"], cfg["window"])
    flops = 4 * b * h * d * pairs
    t_ops = flops / BF16_TC_FLOPS * 1e3
    t_bytes = elt * b * s * d * (2 * h + 2 * hk) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), pairs


def _qkv(gen, cfg: dict, dtype, device):
    b, s, h, hk, d = cfg["b"], cfg["s"], cfg["h"], cfg["hk"], cfg["d"]
    return tuple(
        torch.randn(shape, generator=gen, device=device).to(dtype)
        for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    )


def _sdpa_ms(q, k, v, cfg: dict) -> tuple[float | None, str]:
    """One ``scaled_dot_product_attention`` call on the same inputs, as a
    yardstick: the flash backend with GQA for the causal case; for a
    window, the memory-efficient backend with an explicit boolean mask and
    the kv heads repeated (that backend takes a mask but not GQA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    g = cfg["h"] // cfg["hk"]
    qt = q.transpose(1, 2)
    if cfg["window"] is None:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def call():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return sdpa(qt, kt, vt, is_causal=cfg["causal"], enable_gqa=True)

        ms, note = _library_ms(call, 5)
        return ms, f"SDPA flash backend, is_causal, enable_gqa: {note}"
    s, w = cfg["s"], cfg["window"]
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return sdpa(qt, kt, vt, attn_mask=mask)

    ms, note = _library_ms(call, 5)
    return ms, f"SDPA memory-efficient backend, boolean window mask, kv heads repeated: {note}"


def _flash_variant(q, k, v) -> str:
    """The kernel ``flash_attention`` picks for these inputs."""
    return variant_for(q.shape[-1], q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _flash_small_cases(device, seed: int) -> list[dict]:
    """tests/test_kernels.py's FLASH_CASES, MQA, ragged non-causal S, an
    odd head dimension; each against the plain version on the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    cases = (
        # b, s, h, hk, d, causal, window, dtype
        (2, 256, 4, 2, 64, True, None, torch.float32),
        (1, 128, 2, 2, 128, True, None, torch.float32),
        (2, 256, 4, 4, 64, True, 64, torch.float32),
        (1, 160, 2, 1, 48, True, None, torch.float32),
        (1, 512, 8, 2, 64, True, 128, torch.float32),
        (2, 256, 4, 2, 64, True, None, torch.bfloat16),
        (1, 384, 6, 3, 96, True, None, torch.bfloat16),
        (1, 128, 2, 2, 64, False, None, torch.float32),
        (1, 2048, 16, 1, 128, True, None, torch.bfloat16),  # MQA
        (1, 160, 2, 1, 64, False, None, torch.float32),  # ragged, non-causal
        (1, 200, 2, 1, 64, False, 64, torch.float32),
        (1, 160, 2, 1, 64, False, None, torch.bfloat16),
        (1, 130, 2, 2, 33, True, None, torch.bfloat16),  # odd d: unvectorised loads
        # bfloat16 windows that cut key tiles (64 keys) mid-tile
        (1, 1000, 8, 2, 128, True, 200, torch.bfloat16),
        (2, 700, 6, 3, 96, True, 65, torch.bfloat16),
        (1, 333, 4, 2, 64, False, 100, torch.bfloat16),
        # S not a multiple of the wgmma kernel's 128-row tiles; d = 40 pads
        # to 64 in shared memory
        (2, 333, 4, 2, 64, True, None, torch.bfloat16),
        (1, 200, 4, 1, 128, False, None, torch.bfloat16),
        (1, 129, 2, 1, 40, True, 50, torch.bfloat16),
        (1, 1100, 4, 2, 96, False, 300, torch.bfloat16),
    )
    out = []
    for b, s, h, hk, d, causal, window, dtype in cases:
        cfg = {"b": b, "s": s, "h": h, "hk": hk, "d": d}
        q, k, v = _qkv(gen, cfg, dtype, device)
        got = flash_attention(q, k, v, causal=causal, window=window)
        ref = reference_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        err = _max_abs_err(got.float(), ref.float())
        ratio = None
        if dtype == torch.bfloat16:
            ratio = bf16_tolerance_ratio(got, attention_rows(
                q, k, v, 0, s, causal=causal, window=window))
        _check(got.dtype == dtype and got.shape == q.shape
               and torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol)
               and (ratio is None or ratio <= 1.0),
               f"flash {cfg} causal={causal} window={window} {dtype} disagrees "
               f"(max abs err {err}, scaled bound ratio {ratio})")
        out.append({**cfg, "causal": causal, "window": window, "dtype": str(dtype)[6:],
                    "variant": _flash_variant(q, k, v), "tol": tol, "max_abs_err": err,
                    "tol_ratio": ratio})
    return out


def phase_flash(device, seed: int, scale: int) -> dict:
    """``flash_attention`` at the Mixtral-8x22B 32k prefill and the causal
    8k case (S cut below the full scale)."""
    cut = _cut(scale)
    mains = {
        name: {**cfg, "s": max(4 * FLASH_CHECK_ROWS, cfg["s"] >> cut)}
        for name, cfg in (("mixtral_32k_window", FLASH_MAIN), ("causal_8k", FLASH_CAUSAL))
    }
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inputs = {name: _qkv(gen, cfg, torch.bfloat16, device) for name, cfg in mains.items()}
    torch.cuda.synchronize()

    # -- the entry point's calls, with the launch counts at 0 just before --
    flash_fwd.launches = 0
    flash_fwd.variant_launches = dict.fromkeys(flash_fwd.variant_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    outs = {
        name: flash_attention(*inputs[name], causal=cfg["causal"], window=cfg["window"])
        for name, cfg in mains.items()
    }
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    variant_launches = dict(flash_fwd.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    # -- end of the entry point's calls --
    _check(launches > 0 and variant_launches["bfloat16-wgmma"] > 0,
           "flash_attention launched its bfloat16 TMA/wgmma kernel no time")

    cases = []
    for name, cfg in mains.items():
        q, k, v = inputs[name]
        out = outs[name]
        s = cfg["s"]
        _check(out.shape == q.shape and out.dtype == torch.bfloat16
               and bool(torch.isfinite(out).all()), f"flash {name}: not finite bf16 [B,S,H,d]")
        control = None
        if cfg["window"] is not None and cfg["window"] < s:  # the same call, a window short
            control = flash_attention(q, k, v, causal=cfg["causal"],
                                      window=cfg["window"] - FLASH_CONTROL_SHORT)
        errs = []
        for r0 in (0, s // 2 - FLASH_CHECK_ROWS // 2, s - FLASH_CHECK_ROWS):
            r1 = r0 + FLASH_CHECK_ROWS
            ref = attention_rows(q, k, v, r0, r1, causal=cfg["causal"], window=cfg["window"])
            got = out[:, r0:r1]
            err = _max_abs_err(got.float(), ref)
            ratio = bf16_tolerance_ratio(got, ref)
            _check(torch.allclose(got.float(), ref, atol=FLASH_BF16_TOL, rtol=FLASH_BF16_TOL)
                   and ratio <= 1.0,
                   f"flash {name} rows [{r0}, {r1}) disagree with the plain version "
                   f"(max abs err {err}, scaled bound ratio {ratio})")
            row = {"rows": [r0, r1], "max_abs_err": err, "tol_ratio": ratio,
                   "ref_rms": float(ref.square().mean().sqrt())}
            if control is not None:
                row["control_max_abs_err"] = _max_abs_err(control[:, r0:r1].float(), ref)
                row["control_tol_ratio"] = bf16_tolerance_ratio(control[:, r0:r1], ref)
            errs.append(row)
            del ref, got
        if control is not None:
            # rows past the shortened window change; the bound must see it
            _check(max(r["control_tol_ratio"] for r in errs) > 1.0,
                   f"flash {name}: a window {FLASH_CONTROL_SHORT} keys short passes the "
                   f"scaled bound ({[r['control_tol_ratio'] for r in errs]})")
            del control
        bound_ms, bound_by, pairs = _flash_bound(cfg, 2)
        lib_ms, lib_note = _sdpa_ms(q, k, v, cfg)
        cases.append({
            "case": name, "shape": cfg, "dtype": "bfloat16", "pairs": pairs,
            "variant": _flash_variant(q, k, v),
            "max_abs_err": max(x["max_abs_err"] for x in errs), "checked_rows": errs,
            "ms": _median_ms(
                lambda: flash_attention(q, k, v, causal=cfg["causal"], window=cfg["window"]), 5),
            "plain_ms": _median_ms(
                lambda: reference_attention(q, k, v, causal=cfg["causal"], window=cfg["window"]),
                2),
            "library_ms": lib_ms, "library": lib_note,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        torch.cuda.empty_cache()
    del outs, inputs
    torch.cuda.empty_cache()
    small = _flash_small_cases(device, seed)
    return {
        "cut": cut > 0,
        "launches": launches,
        "variant_launches": variant_launches,
        "peak_device_bytes": peak,
        "tol": FLASH_BF16_TOL,
        "scaled_bound": "bf16_tolerance_ratio <= 1 (flash_attention/ref.py)",
        "cases": cases,
        "small": small,
    }


# -- the LM stack ----------------------------------------------------------------


def _zero_flash_counts() -> None:
    flash_fwd.launches = 0
    flash_fwd.variant_launches = dict.fromkeys(flash_fwd.variant_launches, 0)


def _short_window(cfg, s: int) -> int | None:
    """The control's window: FLASH_CONTROL_SHORT keys short of the keys the
    last row reads (None where it reads no more than that)."""
    keys = min(cfg.sliding_window or s, s)
    return keys - FLASH_CONTROL_SHORT if keys > FLASH_CONTROL_SHORT else None


def _lm_layer_attention(model, tokens) -> dict:
    """Layer 0's attention at the prefill's shape, as the model calls it:
    the kernel against the plain version on the first, a middle and the
    last FLASH_CHECK_ROWS rows (FLASH_BF16_TOL and the scaled bound; a window
    FLASH_CONTROL_SHORT keys short must fail the bound), timed beside its
    bound, the plain version and SDPA."""
    cfg = model.cfg
    layer = model.stacks()[0][1][0]
    with torch.inference_mode():
        q, k, v = gqa_qkv(layer.attn, cfg, rms_norm(model.embed[tokens], layer.attn_norm))
        out = gqa_attend(q, k, v, cfg)
        short = _short_window(cfg, q.shape[1])
        control = None if short is None else flash_attention(q, k, v, causal=True, window=short)
    torch.cuda.synchronize()
    b, s, h, d = q.shape
    shape = {"b": b, "s": s, "h": h, "hk": k.shape[2], "d": d, "causal": True,
             "window": cfg.sliding_window}
    rows = []
    for r0 in sorted({0, max(0, s // 2 - FLASH_CHECK_ROWS // 2), max(0, s - FLASH_CHECK_ROWS)}):
        r1 = min(s, r0 + FLASH_CHECK_ROWS)
        ref = attention_rows(q, k, v, r0, r1, causal=True, window=cfg.sliding_window)
        err = _max_abs_err(out[:, r0:r1].float(), ref)
        ratio = bf16_tolerance_ratio(out[:, r0:r1], ref)
        _check(torch.allclose(out[:, r0:r1].float(), ref, atol=FLASH_BF16_TOL,
                              rtol=FLASH_BF16_TOL) and ratio <= 1.0,
               f"lm {cfg.name} layer 0 attention rows [{r0}, {r1}) disagree with the plain "
               f"version (max abs err {err}, scaled bound ratio {ratio})")
        rows.append({"rows": [r0, r1], "max_abs_err": err, "tol_ratio": ratio})
        if control is not None:
            rows[-1]["control_tol_ratio"] = bf16_tolerance_ratio(control[:, r0:r1], ref)
    _check(control is None or max(r["control_tol_ratio"] for r in rows) > 1.0,
           f"lm {cfg.name}: a window {FLASH_CONTROL_SHORT} keys short passes the scaled bound")
    del control
    bound_ms, bound_by, pairs = _flash_bound(shape, q.element_size())
    lib_ms, lib_note = _sdpa_ms(q, k, v, shape)
    return {
        "case": f"{cfg.name}_layer0_{s}", "shape": shape, "dtype": str(q.dtype)[6:],
        "pairs": pairs, "variant": _flash_variant(q, k, v),
        "max_abs_err": max(r["max_abs_err"] for r in rows), "checked_rows": rows,
        "ms": _median_ms(lambda: gqa_attend(q, k, v, cfg), 5),
        "plain_ms": _median_ms(lambda: reference_attention(
            q, k, v, causal=True, window=cfg.sliding_window), 1),
        "library_ms": lib_ms, "library": lib_note,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _lm_layer_mla(model, tokens) -> dict:
    """Layer 0's MLA at the prefill's shape, as the model calls it: plain
    PyTorch on every device (the reference's MLA reaches no kernel), timed
    once between CUDA events (the prefill has run it at this shape)."""
    cfg = model.cfg
    layer = model.stacks()[0][1][0]
    with torch.inference_mode():
        x = rms_norm(model.embed[tokens], layer.attn_norm)
        ms = _once_ms(lambda: mla_forward(layer.attn, cfg, x))
    m = cfg.mla
    return {"case": f"{cfg.name}_layer0_mla_{tokens.shape[1]}", "route": "plain torch",
            "heads": cfg.n_heads, "kv_lora_rank": m.kv_lora_rank,
            "qk_dim": m.qk_nope_dim + m.qk_rope_dim, "v_dim": m.v_head_dim,
            "q_tile": lm_attention._MLA_Q_TILE, "key_chunk": lm_attention._ATTN_CHUNK, "ms": ms}


@contextlib.contextmanager
def _dropped_pairs():
    """While inside, every MoE layer of ``models.transformer`` first counts
    the (token, k) pairs its routing drops (``moe.route(...).kept()`` on the
    layer's own input), then computes as before; yields the list of counts,
    one a layer call."""
    import repro_torch.models.transformer as transformer

    counts, inner = [], transformer.moe_ffn_groups

    def counting(p, cfg, x, *, mesh=None, replicated=False):
        kept = route(p, cfg, x, mesh, replicated=replicated).kept()
        counts.append({"tokens": kept.shape[0], "pairs": kept.numel(),
                       "dropped": int((~kept).sum())})
        return inner(p, cfg, x, mesh=mesh, replicated=replicated)

    transformer.moe_ffn_groups = counting
    try:
        yield counts
    finally:
        transformer.moe_ffn_groups = inner


def _lm_mtp(model, device, seed: int) -> dict:
    """DeepSeek-V3's training loss with its MTP block, forward only, at
    LM_MTP_S tokens (see LM_MTP_S): the MTP term is the loss less the same
    model's loss with the block switched off, over MTP_WEIGHT."""
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (1, LM_MTP_S + 1), generator=_gen(device, seed + 5),
                           device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), _dropped_pairs() as drops:
        loss, stats = lm_loss_and_stats(model, tokens)
        torch.cuda.synchronize()
    loss_s = time.perf_counter() - t0
    model.cfg = dataclasses.replace(cfg, mtp_depth=0)
    try:
        with torch.inference_mode():
            bare, _ = lm_loss_and_stats(model, tokens)
    finally:
        model.cfg = cfg
    loads = stats["moe_loads"].float()
    sums = loads.sum(dim=-1).tolist()
    res = {"s": LM_MTP_S, "batch": 1, "dtype": str(model.embed.dtype)[6:],
           "loss": float(loss), "loss_without_mtp": float(bare),
           "mtp_loss": float((loss - bare) / MTP_WEIGHT), "loss_s": loss_s,
           "moe_loads_sum": sums, "moe_loads_max": loads.max(dim=-1).values.tolist(),
           "dropped_pairs": drops}
    _check(all(np.isfinite([res["loss"], res["mtp_loss"]])) and res["mtp_loss"] > 0,
           f"lm {cfg.name}: the loss with MTP is not finite ({res})")
    _check(len(sums) == cfg.n_moe_layers and all(abs(x - 1.0) <= LM_LOADS_TOL for x in sums),
           f"lm {cfg.name}: MoE loads sum to {sums}, not 1 within {LM_LOADS_TOL}")
    return res


def _dispatch_elements(cfg, t: int) -> int:
    """The elements of one MoE layer's ``[G, E*C, D]`` dispatch tensors at
    ``t`` tokens on one rank."""
    g = _n_groups(t)
    return g * cfg.moe.n_experts * _capacity(t // g, cfg.moe) * cfg.d_model


def _moe_big_check(model, t: int, device, seed: int) -> dict:
    """The first MoE layer at ``t`` tokens, held as MOE_BIG_SHARE says."""
    cfg, mc = model.cfg, model.cfg.moe
    p = model.moe_layers[0].moe
    gen = _gen(device, seed + 6)
    x = torch.randn((t, cfg.d_model), generator=gen, device=device)
    x = (x + torch.randn(cfg.d_model, generator=gen, device=device)).to(model.embed.dtype)
    with torch.inference_mode():
        r = route(p, mc, x)
        y = moe_ffn_groups(p, mc, x)[0]
        rows = torch.cat([torch.arange(r.t_loc), torch.arange(t - r.t_loc, t)]).to(device)
        kept = r.kept()[rows]
        idx, prob = r.top_idx.reshape(t, -1)[rows], r.probs.reshape(t, -1)[rows]
        xs = x[rows].float()
        shared = torch.zeros_like(xs)
        if mc.n_shared:
            sh = p.shared
            shared += (F.silu(xs @ sh.w_gate.float()) * (xs @ sh.w_up.float())) @ \
                sh.w_down.float()
        ref, every = shared.clone(), shared
        for e in range(mc.n_experts):
            w_all = (prob * (idx == e)).sum(-1)
            hit = w_all.nonzero()[:, 0]
            if hit.numel() == 0:
                continue
            xe = xs[hit]
            ye = (F.silu(xe @ p.we_gate[e].float()) * (xe @ p.we_up[e].float())) @ \
                p.we_down[e].float()
            w_kept = (prob * (idx == e) * kept).sum(-1)[hit]
            ref[hit] += w_kept[:, None] * ye
            every[hit] += w_all[hit][:, None] * ye
        rms = float(ref.square().mean().sqrt())
        got = y[rows].float()
        share = float((got - ref).square().mean().sqrt()) / rms
        control = float((got - every).square().mean().sqrt()) / rms
    elements = _dispatch_elements(cfg, t)
    res = {"tokens": t, "groups": r.g, "capacity": r.cap, "dispatch_elements": elements,
           "last_group_first_element": (r.g - 1) * mc.n_experts * r.cap * cfg.d_model,
           "checked_tokens": rows.numel(), "dropped_pairs_checked": int((~kept).sum()),
           "rms_share": share, "bound": MOE_BIG_SHARE, "max_abs_err": _max_abs_err(got, ref),
           "control_with_drops_added": control}
    _check(share <= MOE_BIG_SHARE and control > MOE_BIG_SHARE,
           f"lm {cfg.name}: the MoE layer at {t} tokens is {share} of the rms off its "
           f"reference (control {control}, bound {MOE_BIG_SHARE})")
    return res


def _big_params(model) -> list:
    """Every parameter of more than 2**31 elements: each must lie whole on
    the card, contiguous, and its last slice along dim 0 (past element
    2**31) drawn at the initializer's scale, 1/sqrt(shape[1]) (the
    experts' d_in: ``init_dense(d_model, E*F)`` and ``(F, E*d_model)``
    reshaped)."""
    out = []
    for name, p in model.named_parameters():
        if p.numel() <= 2**31:
            continue
        std = float(p[-1].detach().float().std()) * float(np.sqrt(p.shape[1]))
        out.append({"name": name, "shape": list(p.shape), "numel": p.numel(),
                    "last_slice_std_over_scale": std})
        _check(p.is_cuda and p.is_contiguous() and abs(std - 1.0) < 0.01,
               f"{name} {list(p.shape)}: not whole on the card or its tail not drawn ({std})")
    return out


def _last_logits(model, tokens, backend=None) -> torch.Tensor:
    with torch.inference_mode():
        h, _, _ = lm_hidden(model, tokens, backend=backend)
        return lm_logits(model, h[:, -1:])[:, -1].float()


def _lm_logits_check(model, tokens, share: float, gate: bool) -> dict:
    """The whole model's last-position logits at LM_CHECK_S tokens, ``cuda``
    against ``torch``.  With ``gate`` they must lie within ``share`` of the
    logits' rms, and the same run with every layer's window
    FLASH_CONTROL_SHORT keys short must miss that bound; without, the
    distance is reported."""
    cfg = model.cfg
    t = tokens[:, :LM_CHECK_S]
    s = t.shape[1]
    got = _last_logits(model, t)
    ref = _last_logits(model, t, backend="torch")
    bound = share * float(ref.square().mean().sqrt())
    ratio = _max_abs_err(got, ref) / bound
    _check(bool(torch.isfinite(got).all()) and (not gate or ratio <= 1.0),
           f"lm {cfg.name}: logits at S={s} off the torch backend by {ratio} of the bound")
    res = {"s": s, "dtype": str(model.embed.dtype)[6:], "gated": gate, "share": share,
           "bound": bound,
           "max_abs_err": _max_abs_err(got, ref), "tol_ratio": ratio,
           "same_next_token": bool(torch.equal(got.argmax(-1), ref.argmax(-1)))}
    short = _short_window(cfg, s)
    if gate and short is not None:
        model.cfg = dataclasses.replace(cfg, sliding_window=short)
        try:
            control = _last_logits(model, t)
        finally:
            model.cfg = cfg
        res["control_window"] = short
        res["control_tol_ratio"] = _max_abs_err(control, ref) / bound
        _check(res["control_tol_ratio"] > 1.0,
               f"lm {cfg.name}: a window {FLASH_CONTROL_SHORT} keys short passes the logits "
               f"bound ({res['control_tol_ratio']})")
    return res


def _lm_float32_checks(cfg, tokens, device, seed: int) -> tuple[dict, dict, dict]:
    """The float32 model at the published widths, its build timed and its
    peak read: the logits check (gated where a GQA layer runs the kernel;
    under MLA both backends run the same plain code, so it is reported)
    and the decode replay against the forward: LM_REPLAY_S greedy-prefix
    steps through ``lm_decode_step``, each step's logits within
    LM_LOGIT_SHARE of the full forward's logits' rms at that position; the
    same replay with every token written one slot late must miss it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=_gen(device, seed + 2), device=device,
                        dtype=torch.float32)
    torch.cuda.synchronize()
    build = {"dtype": "float32", "init_s": time.perf_counter() - t0,
             "init_peak_device_bytes": torch.cuda.max_memory_allocated(),
             "params": sum(p.numel() for p in model.parameters())}
    logits = _lm_logits_check(model, tokens, LM_LOGIT_SHARE, gate=cfg.mla is None)
    toks = tokens[:, :LM_REPLAY_S]

    def replay(late: int) -> float:
        cache = init_lm_cache(cfg, 1, LM_REPLAY_S, torch.float32, device)
        err = 0.0
        for pos in range(LM_REPLAY_S - late):
            lg, cache = lm_decode_step(model, cache, toks[:, pos:pos + 1], pos + late)
            err = max(err, _max_abs_err(lg[0, 0], full[0, pos]))
        return err

    with torch.inference_mode():
        full = lm_forward(model, toks)[0]
        tol = LM_LOGIT_SHARE * float(full.float().square().mean().sqrt())
        err, control = replay(0), replay(1)
    _check(err <= tol, f"lm {cfg.name}: decode replay off the forward by {err} (> {tol})")
    _check(control > tol, f"lm {cfg.name}: a replay one cache slot late passes the bound "
                          f"({control} <= {tol})")
    del model, full
    torch.cuda.empty_cache()
    return build, logits, {"s": LM_REPLAY_S, "dtype": "float32", "max_abs_err": err,
                           "tol": tol, "control_one_slot_late": control}


def _decode_cache(cfg, dtype, device, seed: int, batch: int | None = None,
                  cache_len: int | None = None):
    """decode_32k's cache at ``batch`` sequences and ``cache_len`` slots (by
    default LM_DECODE_BATCH and LM_DECODE_CACHE), every slot holding seeded
    keys and values, and the generator that drew them."""
    gen = _gen(device, seed + 4)
    cache = init_lm_cache(cfg, batch or LM_DECODE_BATCH, cache_len or LM_DECODE_CACHE, dtype,
                          device)
    for leaves in cache.values():
        for t in leaves.values():
            t.normal_(generator=gen)
    return cache, gen


def _lm_decode(arch: str, model, device, seed: int, refs: bool) -> dict:
    """decode_32k's step at LM_DECODE_BATCH sequences: LM_DECODE_TOKENS
    greedy tokens against a LM_DECODE_CACHE-slot cache whose earlier slots
    hold seeded keys and values, timed between CUDA events.  Then, with
    ``refs``, the serve_mesh phase's reference (DECODE_REFS): the same
    positions from the same seeded cache, teacher-forced with this run's
    tokens, each step's last logits."""
    cfg = model.cfg
    torch.cuda.empty_cache()
    bundle = build_bundle(arch, "decode_32k", config=cfg, device=device)
    cache, gen = _decode_cache(cfg, model.embed.dtype, device, seed)
    cache_bytes = sum(t.numel() * t.element_size() for v in cache.values() for t in v.values())
    state = {"params": model, "cache": cache}
    tok = torch.randint(0, cfg.vocab, (LM_DECODE_BATCH, 1), generator=gen, device=device)
    pos0 = LM_DECODE_CACHE - LM_DECODE_TOKENS - 1
    toks = [tok]
    state, out = bundle.step_fn(state, {"tokens": tok, "pos": pos0})  # warm-up
    tok = out["next_token"][:, None]
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(LM_DECODE_TOKENS):
        toks.append(tok)
        state, out = bundle.step_fn(state, {"tokens": tok, "pos": pos0 + 1 + i})
        tok = out["next_token"][:, None]
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    # cuBLAS's Hopper GEMMs are the kernels named nvjet_*
    profile = _profile(lambda: bundle.step_fn(
        state, {"tokens": tok, "pos": LM_DECODE_CACHE - 1}), "nvjet", "gemm_ms")
    _check(tok.shape == (LM_DECODE_BATCH, 1) and bool(((tok >= 0) & (tok < cfg.vocab)).all()),
           f"lm {arch}: decode tokens out of range")
    del state, cache
    torch.cuda.empty_cache()
    line = {"batch": LM_DECODE_BATCH, "cache_len": LM_DECODE_CACHE, "cache_bytes": cache_bytes,
            "tokens": LM_DECODE_TOKENS, "positions": [pos0 + 1, pos0 + LM_DECODE_TOKENS],
            "ms_per_token": ms / LM_DECODE_TOKENS,
            "tokens_per_s": LM_DECODE_BATCH * LM_DECODE_TOKENS / (ms / 1e3),
            "profile": profile,
            "cut": {"batch": [ARCHS[arch].shapes()["decode_32k"].global_batch,
                              LM_DECODE_BATCH]}}
    if not refs:
        return line
    dtype = model.embed.dtype
    refs, ref_s = [], []
    for to, steps in ((dtype, len(toks)), (torch.float32, DECODE_F32_STEPS)):
        t0 = time.perf_counter()
        cache, _ = _decode_cache(cfg, dtype, device, seed)  # drawn as above, then cast
        cache = {k: {n: t.to(to) for n, t in v.items()} for k, v in cache.items()}
        model.to(to)  # the float32 pass is this model's last use
        logits = []
        with torch.inference_mode():
            for i, t in enumerate(toks[:steps]):
                lg, cache = lm_decode_step(model, cache, t, pos0 + i)
                logits.append(lg[:, -1].float())
        refs.append(torch.stack(logits).cpu())
        del cache, logits
        torch.cuda.empty_cache()
        ref_s.append(time.perf_counter() - t0)
    DECODE_REFS[arch] = (cfg, torch.stack(toks).cpu(), pos0, LM_DECODE_CACHE, *refs)
    return {**line, "serve_mesh_refs_s": dict(zip(("bfloat16", "float32"), ref_s))}


def _lm_model_run(arch: str, layers: int | None, device, seed: int, scale: int) -> dict:
    """One model: built from ``seed`` through the prefill bundle (its build
    timed and its peak read), its prefill counted (every GQA layer must
    launch the TMA/wgmma flash kernel once, an MLA layer none; an MoE
    layer's dropped pairs read), timed and read for its peak; then held
    (layer 0's GQA attention, or MLA's time; the logits; the decode replay),
    decode timed (LM_DECODED) and DeepSeek-V3's MTP loss run."""
    cfg = ARCHS[arch].config
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    s = max(2 * FLASH_CHECK_ROWS, LM_PREFILL_S >> _cut(scale))
    marks = [time.perf_counter()]
    stage_s = {}

    def mark(stage: str) -> None:  # host seconds since the previous mark
        marks.append(time.perf_counter())
        stage_s[stage] = marks[-1] - marks[-2]

    bundle = build_bundle(arch, "prefill_32k", config=cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = bundle.init_state_fn(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    model = state["params"]
    big = _big_params(model)
    tokens = torch.randint(0, cfg.vocab, (LM_PREFILL_BATCH, s),
                           generator=_gen(device, seed + 1), device=device)
    torch.cuda.synchronize()
    gqa_layers = 0 if cfg.mla else cfg.n_layers

    # -- the prefill step, with the flash launch counts at 0 just before --
    _zero_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    with _dropped_pairs() as drops:
        out = bundle.step_fn(state, {"tokens": tokens})
        torch.cuda.synchronize()
    launches, variants = flash_fwd.launches, dict(flash_fwd.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    # -- end of the prefill step --
    _check(launches == gqa_layers and variants["bfloat16-wgmma"] == gqa_layers,
           f"lm {arch}: prefill launched flash {variants}, not {gqa_layers} x bfloat16-wgmma "
           f"(one a GQA layer)")
    if arch in LM_RANKED:  # the one-rank last-position logits, for the model_axis phase
        PREFILL_REFS[arch] = (cfg, tokens.cpu(), _last_logits(model, tokens).cpu())
    nxt = out["next_token"]
    _check(nxt.shape == (LM_PREFILL_BATCH,) and bool(((nxt >= 0) & (nxt < cfg.vocab)).all()),
           f"lm {arch}: prefill's next token out of range")
    def step():
        return bundle.step_fn(state, {"tokens": tokens})

    # the others: the counted call was the warm-up
    prefill_ms = _median_ms(step, 3) if arch in LM_RANKED else _once_ms(step)
    profiled = arch in LM_RANKED or cfg.mla is not None
    profile = _profile(step, "flash_fwd", "flash_kernel_ms") if profiled else None
    mark("build_and_prefill")
    published = ARCHS[arch].config
    res = {
        "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head], "window": cfg.sliding_window,
        "vocab": cfg.vocab, "attention": None,
        "moe": None if cfg.moe is None else [cfg.moe.n_experts, cfg.moe.top_k],
        "params": sum(p.numel() for p in model.parameters()), "init_s": init_s,
        "init_peak_device_bytes": init_peak, "params_over_2_31": big,
        "prefill": {"batch": LM_PREFILL_BATCH, "s": s, "prefill_ms": prefill_ms,
                    "timed": "median of 3" if arch in LM_RANKED else "once, after the counted call",
                    "tokens_per_s": LM_PREFILL_BATCH * s / (prefill_ms / 1e3),
                    "peak_device_bytes": peak, "flash_launches": launches,
                    "gqa_layers": gqa_layers, "variant_launches": variants,
                    "dropped_pairs": drops, "profile": profile},
        "cut": {"batch": [ARCHS[arch].shapes()["prefill_32k"].global_batch, LM_PREFILL_BATCH],
                **({"n_layers": [published.n_layers, cfg.n_layers]} if layers else {}),
                **({"s": [LM_PREFILL_S, s]} if s != LM_PREFILL_S else {})},
    }
    if cfg.mla:
        res["mla_layer0"] = _lm_layer_mla(model, tokens)
    else:
        res["attention"] = _lm_layer_attention(model, tokens)
    mark("layer0")
    res["logits_bf16"] = _lm_logits_check(model, tokens, LM_BF16_LOGIT_SHARE,
                                          gate=arch in LM_BF16_GATED)
    mark("logits_bf16")
    if arch in LM_DECODED:
        res["decode"] = _lm_decode(arch, model, device, seed, refs=arch == LM_DECODED[0])
        mark("decode")
    if cfg.mtp_depth:
        res["mtp"] = {**_lm_mtp(model, device, seed), "dropped_pairs_prefill": drops}
        mark("mtp")
    if cfg.moe and _dispatch_elements(cfg, LM_PREFILL_BATCH * s) > MOE_BIG_ELEMENTS:
        res["moe_prefill_tokens"] = _moe_big_check(model, LM_PREFILL_BATCH * s, device, seed)
        mark("moe_prefill_tokens")
    del state, model, out
    torch.cuda.empty_cache()
    res["float32_build"], res["logits"], res["replay"] = _lm_float32_checks(cfg, tokens, device,
                                                                           seed)
    mark("float32")
    res["stage_s"] = stage_s
    return res


def phase_lm(device, seed: int, scale: int) -> dict:
    """The LM serving path (``repro_torch.launch.steps``) at the published
    widths of ``LM_MODELS``, then ``serve_batch`` at its reduced config."""
    runs = [_lm_model_run(arch, layers, device, seed, scale) for arch, layers in LM_MODELS]
    tokens = serve_batch(LM_MODELS[0][0], device=device, seed=seed, verbose=False)
    again = serve_batch(LM_MODELS[0][0], device=device, seed=seed, verbose=False)
    _check(tokens.shape == (4, 16) and np.array_equal(tokens, again),
           "serve_batch on the card: not [4, 16] or not the same tokens twice")
    return {
        "cut": _cut(scale) > 0,
        "launches": sum(r["prefill"]["flash_launches"] for r in runs),
        "launches_by_model": {r["arch"]: r["prefill"]["flash_launches"] for r in runs},
        "models": runs,
        "serve_batch": {"arch": LM_MODELS[0][0], "config": "reduced", "tokens": tokens.tolist()},
    }


# -- recsys --------------------------------------------------------------------------


def _host_f64(model) -> types.SimpleNamespace:
    """DeepFM's parameters on the host in float64, for the functions of
    ``models.recsys`` to run as an oracle."""
    mlp = copy.deepcopy(model.mlp).to("cpu", torch.float64)
    return types.SimpleNamespace(
        tables=model.tables.detach().to("cpu", torch.float64),
        first_order=model.first_order.detach().to("cpu", torch.float64),
        mlp=mlp, bias=model.bias.detach().to("cpu", torch.float64))


def _recsys_bag(model, device, seed: int) -> dict:
    """The ragged bag over field 0's table: RECSYS_BAGS bags of 1 to
    RECSYS_BAG_MAX ids through ``embedding_bag_segment`` (the segment-sum
    kernel at D = 10, counted), held per bag against float64 and timed
    beside its bound and ``index_add_`` (``_seg_case``), and the whole entry
    (gather, sort, kernel) timed."""
    table = model.tables.detach()[0]
    v, d = table.shape
    rng = np.random.default_rng(seed + 5)
    lengths = rng.integers(1, RECSYS_BAG_MAX + 1, RECSYS_BAGS)
    bag_ids = torch.as_tensor(np.repeat(np.arange(RECSYS_BAGS, dtype=np.int32), lengths),
                              device=device)
    flat_ids = torch.as_tensor(rng.integers(0, v, int(lengths.sum())).astype(np.int32),
                               device=device)
    nnz = int(flat_ids.shape[0])
    torch.cuda.synchronize()
    with torch.inference_mode():
        # -- the entry's call, with the launch count at 0 just before --
        segment_sum_sorted.launches = 0
        out = embedding_bag_segment(table, flat_ids, bag_ids, RECSYS_BAGS)
        torch.cuda.synchronize()
        launches = segment_sum_sorted.launches
        # -- end of the entry's call --
        _check(launches == len(segment_levels(nnz, d)),
               f"recsys bag: {launches} launches, not {len(segment_levels(nnz, d))}")
        rows = table.index_select(0, flat_ids.long())
        case = _seg_case(f"recsys_bag_d{d}", out, bag_ids, rows, RECSYS_BAGS)
        bag_ms = _median_ms(
            lambda: embedding_bag_segment(table, flat_ids, bag_ids, RECSYS_BAGS), 5)
    return {**case, "launches": launches, "levels": segment_levels(nnz, d), "bag_ms": bag_ms,
            "bag_lengths": [1, RECSYS_BAG_MAX]}


def phase_recsys(device, seed: int) -> dict:
    """DeepFM's serving path (``repro_torch.launch.steps``) at its published
    config: serve_bulk's scores and retrieval_cand's top 100, each held on the
    host in float64 and timed; then the ragged bag on the segment-sum kernel."""
    cfg = ARCHS["deepfm"].config
    serve = build_bundle("deepfm", "serve_bulk", device=device)
    retrieval = build_bundle("deepfm", "retrieval_cand", device=device)
    t0 = time.perf_counter()
    state = serve.init_state_fn(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state["params"]
    gen = _gen(device, seed + 1)
    ids = torch.randint(0, cfg.vocab_per_field, serve.abstract_inputs["ids"].shape,
                        generator=gen, device=device, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    scores = serve.step_fn(state, {"ids": ids})["scores"]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _check(scores.shape == (ids.shape[0],) and bool(torch.isfinite(scores).all())
           and bool(((scores >= 0) & (scores <= 1)).all()), "recsys serve: scores not in [0, 1]")
    host = _host_f64(model)
    with torch.inference_mode():
        ref = torch.sigmoid(deepfm_logits(host, ids[:RECSYS_CHECK_ROWS].cpu()))
    serve_err = _max_abs_err(scores[:RECSYS_CHECK_ROWS].cpu(), ref)
    _check(serve_err <= RECSYS_SCORE_TOL, f"recsys serve: scores off float64 by {serve_err}")
    serve_ms = _median_ms(lambda: serve.step_fn(state, {"ids": ids}), 5)

    n_cand = retrieval.abstract_inputs["candidates"].shape[0]
    q_ids = torch.randint(0, cfg.vocab_per_field, retrieval.abstract_inputs["ids"].shape,
                          generator=gen, device=device, dtype=torch.int32)
    cands = torch.randn((n_cand, cfg.embed_dim), generator=gen, device=device)
    batch = {"ids": q_ids, "candidates": cands}
    top = retrieval.step_fn(state, batch)
    torch.cuda.synchronize()
    k = top["top_ids"].shape[1]
    with torch.inference_mode():
        full64 = retrieval_scores(host, q_ids.cpu(), cands.cpu().double())[0]
    kth = float(torch.topk(full64, k).values[-1])
    got_ids = top["top_ids"][0].cpu()
    score_err = _max_abs_err(top["top_scores"][0].cpu(), full64[got_ids])
    # every id returned is a top-k id of the float64 scores, up to a near tie
    _check(score_err <= RECSYS_SCORE_TOL and len(set(got_ids.tolist())) == k
           and bool((full64[got_ids] >= kth - RECSYS_SCORE_TOL).all()),
           f"recsys retrieval: top {k} off the float64 top {k} (score err {score_err})")
    retrieval_ms = _median_ms(lambda: retrieval.step_fn(state, batch), 5)
    RECSYS_REFS.update(scores=scores.cpu(), top_ids=top["top_ids"].cpu(),
                       top_scores=top["top_scores"].cpu())
    del host, full64
    bag = _recsys_bag(model, device, seed)
    del state, model, scores, cands
    torch.cuda.empty_cache()
    return {
        "config": {"fields": cfg.n_sparse, "rows": cfg.vocab_per_field, "dim": cfg.embed_dim,
                   "mlp": list(cfg.mlp_dims), "multi_hot": cfg.multi_hot},
        "init_s": init_s,
        "serve_bulk": {"batch": ids.shape[0], "ms": serve_ms,
                       "requests_per_s": ids.shape[0] / (serve_ms / 1e3),
                       "peak_device_bytes": peak, "checked_rows": RECSYS_CHECK_ROWS,
                       "max_abs_err_vs_float64": serve_err},
        "retrieval_cand": {"candidates": n_cand, "k": k, "ms": retrieval_ms,
                           "max_abs_err_vs_float64": score_err},
        "tol": RECSYS_SCORE_TOL,
        "launches": bag["launches"],
        "bag": bag,
    }


# -- training ------------------------------------------------------------------------


def _attention_grads(named_grads) -> list:
    return [g for n, g in named_grads
            if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv") and g is not None]


def _lm_grad_stats(model, tokens, backend, micro: int) -> dict:
    """The loss, the global gradient norm and the attention projections'
    gradient norm of ``model`` on ``tokens``, ``micro`` sequences at a
    time (the gradients averaged, float32)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    acc, loss_sum = None, 0.0
    b = tokens.shape[0]
    for chunk in tokens.split(micro):
        loss, _ = lm_loss_and_stats(model, chunk, backend=backend)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        w = chunk.shape[0] / b
        grads = [None if g is None else g.to(torch.float32) * w for g in grads]
        acc = grads if acc is None else [
            a if g is None else (g if a is None else a + g) for a, g in zip(acc, grads)]
        loss_sum += float(loss.detach()) * w
        del loss, grads
    attn = _attention_grads(zip((n for n, _ in named), acc))
    return {"loss": loss_sum, "gnorm": float(global_norm(acc)),
            "attn_gnorm": float(global_norm(attn)) if attn else 0.0}


def _rel_off(got: dict, ref: dict) -> dict:
    return {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in TRAIN_GATE_RTOL}


def _train_lm(device, seed: int) -> dict:
    """TinyLlama's train step at its published widths (see TRAIN_LM_*): the
    float32 reference and the control on step 1's batch, then the steps
    timed by CUDA events, step 1's gradients read for the gate."""
    spec = ARCHS[TRAIN_LM_ARCH]
    cfg = spec.config
    shape = spec.shapes()["train_4k"]
    _check(cfg.remat, "train: the published config trains without remat")
    bundle = build_bundle(TRAIN_LM_ARCH, "train_4k", device=device)
    t0 = time.perf_counter()
    state = bundle.init_state_fn(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state["params"]
    tokens_spec = {"tokens": InputSpec((TRAIN_LM_BATCH, shape.seq_len + 1), torch.int32)}
    batches = [make_batch(tokens_spec, seed=seed, step=i, bounds=bundle.input_bounds,
                          device=device) for i in range(TRAIN_LM_STEPS)]

    # -- the float32 reference and the control, on step 1's batch --
    tokens = batches[0]["tokens"]
    model32 = copy.deepcopy(model).to(torch.float32)
    ref = _lm_grad_stats(model32, tokens, "torch", micro=1)
    del model32
    torch.cuda.empty_cache()
    real_attend = lm_attention.gqa_attend
    lm_attention.gqa_attend = lambda q, k, v, cfg, backend=None: real_attend(
        q.detach(), k.detach(), v.detach(), cfg, backend="torch")
    try:
        ctrl = _lm_grad_stats(model, tokens, None, micro=TRAIN_LM_BATCH)
    finally:
        lm_attention.gqa_attend = real_attend
    torch.cuda.empty_cache()

    # -- the steps, with the flash launch count at 0 just before --
    seen = {}
    real_update = train_steps.adamw_update

    def reading_update(model, grads, opt, opt_cfg):
        # step 1's gradients as the step hands them to the optimizer
        seen["attn_gnorm"] = float(global_norm(_attention_grads(grads.items())))
        return real_update(model, grads, opt, opt_cfg)

    _zero_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms = [], [], []
    for i, b in enumerate(batches):
        train_steps.adamw_update = reading_update if i == 0 else real_update
        try:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = bundle.step_fn(state, b)
            stop.record()
            stop.synchronize()
        finally:
            train_steps.adamw_update = real_update
        step_ms.append(start.elapsed_time(stop))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    flash_launches = flash_fwd.launches
    # -- end of the steps --
    _check(flash_launches == 0, f"train lm: the flash kernel ran {flash_launches} times "
                                "under grad")
    _check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), "train lm: not finite")
    got = {"loss": losses[0], "gnorm": gnorms[0], "attn_gnorm": seen["attn_gnorm"]}
    off, ctrl_off = _rel_off(got, ref), _rel_off(ctrl, ref)
    _check(all(off[k] <= TRAIN_GATE_RTOL[k] for k in off),
           f"train lm: bfloat16 step 1 off float32 by {off} (bound {TRAIN_GATE_RTOL})")
    _check(any(ctrl_off[k] > TRAIN_GATE_RTOL[k] for k in ctrl_off),
           f"train lm: the control (attention's gradient cut) passed the gate: {ctrl_off}")
    profile = _profile(lambda: bundle.step_fn(state, batches[0]), "elementwise",
                       "elementwise_ms")
    ms = float(np.median(step_ms[1:]))
    res = {
        "arch": TRAIN_LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head], "remat": cfg.remat,
        "params": sum(p.numel() for p in model.parameters()), "init_s": init_s,
        "batch": TRAIN_LM_BATCH, "s": shape.seq_len,
        "cut": {"global_batch": [shape.global_batch, TRAIN_LM_BATCH]},
        "losses": losses, "gnorms": gnorms, "step_ms_each": step_ms, "step_ms": ms,
        "tokens_per_s": TRAIN_LM_BATCH * shape.seq_len / (ms / 1e3),
        "peak_device_bytes": peak, "flash_launches": flash_launches,
        "gate": {"float32_torch": ref, "bfloat16_step1": got, "off": off,
                 "control_attention_grad_cut": ctrl, "control_off": ctrl_off,
                 "rtol": TRAIN_GATE_RTOL},
        "profile": profile,
    }
    del state, model, batches
    torch.cuda.empty_cache()
    return res


def _state_equal(a: dict, b: dict) -> list:
    """The names of the train-state tensors that differ in any bit."""
    fa, fb = _flat_tree(state_tree(a)), _flat_tree(state_tree(b))
    _check(fa.keys() == fb.keys(), "train: two states of different structure")
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _train_gnn(device, seed: int) -> dict:
    """MeshGraphNet's train steps through ``train()`` with every sum (and
    every gather's gradient) on the segment-sum kernel, counted; then a
    crash and a restart held bit for bit against the straight run."""
    arch, shape = TRAIN_GNN
    kw = dict(steps=TRAIN_GNN_STEPS, reduced=False, ckpt_every=TRAIN_GNN_CKPT, seed=seed,
              verbose=False, device=device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        straight, crashy = str(Path(tmp) / "straight"), str(Path(tmp) / "crashy")
        torch.cuda.reset_peak_memory_stats()
        # -- the straight run, with the launch count at 0 just before --
        ref, launches = _counted(lambda: train(arch, shape, ckpt_dir=straight, **kw))
        # -- end of the straight run --
        peak = torch.cuda.max_memory_allocated()
        losses = ref["losses"]
        _check(launches > 0, "train gnn: the segment-sum kernel ran no time")
        _check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]),
               f"train gnn: the loss did not fall: {losses}")
        crash = None
        try:
            train(arch, shape, ckpt_dir=crashy, crash_at=TRAIN_GNN_CRASH, **kw)
        except RuntimeError as e:
            crash = str(e)
        _check(crash == f"injected crash at step {TRAIN_GNN_CRASH}"
               and latest_step(crashy) == TRAIN_GNN_CKPT,
               f"train gnn: the crash run ended with {crash!r} at {latest_step(crashy)}")
        out = train(arch, shape, ckpt_dir=crashy, **kw)
        diff = _state_equal(ref["final_state"], out["final_state"])
        _check(out["losses"] == losses[TRAIN_GNN_CKPT:] and not diff,
               f"train gnn: the restart differs from the straight run: losses "
               f"{out['losses']} against {losses[TRAIN_GNN_CKPT:]}, tensors {diff[:5]}")
        probe = _atomics_probe(arch, shape, kw)
        model = ref["final_state"]["params"]
        bundle = build_bundle(arch, shape, device=device)
        batch = graph_batch(bundle.abstract_inputs, seed=seed, step=0,
                            n_nodes=bundle.abstract_inputs["x"].shape[0], device=device)
        profile = _profile(lambda: bundle.step_fn(ref["final_state"], batch))
    cfg = ARCHS[arch].config
    return {"arch": arch, "shape": shape, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
            "n_nodes": int(batch["x"].shape[0]), "n_edges": int(batch["edge_src"].shape[0]),
            "d_feat": int(batch["x"].shape[1]),
            "params": sum(p.numel() for p in model.parameters()),
            "steps": TRAIN_GNN_STEPS, "losses": losses,
            "step_ms": 1e3 * float(np.median(ref["step_s"][1:])),
            "step_ms_each": [1e3 * t for t in ref["step_s"]],
            "peak_device_bytes": peak, "launches": launches,
            "launches_per_step": launches / TRAIN_GNN_STEPS,
            "restart": {"checkpoint_at": TRAIN_GNN_CKPT, "crash_at": TRAIN_GNN_CRASH,
                        "resumed_losses": out["losses"], "bit_exact": True},
            "atomics_probe": probe, "profile": profile}


def _atomics_probe(arch: str, shape: str, kw: dict) -> dict:
    """Why the gathers' gradients run on the kernel: the same
    TRAIN_GNN_PROBE_STEPS steps twice with the node-to-edge gathers as
    plain ``index_select`` (whose backward, ``index_add_``, adds by
    atomics), and the train-state tensors that differ between the two runs
    (reported, not gated: an atomic order may happen to repeat)."""
    kw = dict(kw, steps=TRAIN_GNN_PROBE_STEPS)
    kw.pop("ckpt_every")
    real = SortedEdges.gather_src, SortedEdges.gather_dst
    SortedEdges.gather_src = lambda self, t, backend=None: t.index_select(0, self.src)
    SortedEdges.gather_dst = lambda self, t, backend=None: t.index_select(0, self.dst_index)
    try:
        a, b = (train(arch, shape, **kw) for _ in range(2))
    finally:
        SortedEdges.gather_src, SortedEdges.gather_dst = real
    return {"steps": TRAIN_GNN_PROBE_STEPS, "gathers": "index_select",
            "tensors_differing": len(_state_equal(a["final_state"], b["final_state"])),
            "losses": [a["losses"], b["losses"]]}


def _train_recsys(device, seed: int) -> dict:
    cfg = ARCHS["deepfm"].config
    torch.cuda.reset_peak_memory_stats()
    out = train("deepfm", "train_batch", steps=TRAIN_RECSYS_STEPS, reduced=False, seed=seed,
                verbose=False, device=device)
    peak = torch.cuda.max_memory_allocated()
    _check(len(out["losses"]) == TRAIN_RECSYS_STEPS and all(np.isfinite(out["losses"])),
           f"train recsys: {out['losses']}")
    return {"arch": "deepfm", "shape": "train_batch",
            "batch": ARCHS["deepfm"].shapes()["train_batch"].batch,
            "config": {"fields": cfg.n_sparse, "rows": cfg.vocab_per_field,
                       "dim": cfg.embed_dim},
            "losses": out["losses"], "gnorms": out["gnorms"],
            "step_ms": 1e3 * float(np.median(out["step_s"][1:])),
            "step_ms_each": [1e3 * t for t in out["step_s"]], "peak_device_bytes": peak}


def _pna_products_reckoning() -> dict:
    """Why PNA's train step at ogb_products does not run on one card: the
    bytes autograd keeps for its backward, at least; and on R ranks of the
    flattened axis (``launch.steps``), each rank's share: its edges' part
    of those bytes, plus the whole-graph extrema each layer's max and min
    keep for their backward (``[N, d]`` each, all-reduced), and the smallest
    R that divides the graph (``_gnn_sizes`` pads to 512) whose share fits
    the card.  A reckoning: one card cannot hold two ranks' halves."""
    cfg = ARCHS["pna"].config
    shape = GRAPH_SHAPES["ogb_products"]
    e = (shape.n_edges + 511) // 512 * 512
    n = (shape.n_nodes + 511) // 512 * 512
    edge_tensor = e * cfg.d_hidden * 4  # one [E, d] float32 tensor
    # per layer: the gathered message (read by m*m's backward), and max's
    # and min's masked copies (kept for their tie-split backward)
    kept = 3 * edge_tensor * cfg.n_layers
    extrema = 2 * n * cfg.d_hidden * 4 * cfg.n_layers
    card = torch.cuda.get_device_properties(0).total_memory

    def per_rank(r: int) -> int:
        return kept // r + extrema

    fits = next(r for r in (2 ** k for k in range(1, 10)) if per_rank(r) <= card)
    return {"E": e, "N": n, "d_hidden": cfg.d_hidden, "layers": cfg.n_layers,
            "edge_tensor_bytes": edge_tensor, "kept_bytes_at_least": kept,
            "card_bytes": card, "runs": False,
            "ranks": {"kept_bytes_per_rank_at_least": {r: per_rank(r) for r in (2, 4, 8, 16)},
                      "extrema_bytes_per_rank": extrema, "smallest_ranks_that_fit": fits}}


def phase_train(device, seed: int) -> dict:
    """The training stack on the card (see the module docstring)."""
    t0 = time.perf_counter()
    line = {"lm": _train_lm(device, seed)}
    line["gnn"] = _train_gnn(device, seed)
    line["recsys"] = _train_recsys(device, seed)
    line["pna_ogb_products"] = _pna_products_reckoning()
    _check(line["pna_ogb_products"]["kept_bytes_at_least"]
           > line["pna_ogb_products"]["card_bytes"],
           "train: PNA at ogb_products would fit the card; run it")
    line.update(launches=line["gnn"]["launches"], nvidia_smi=_nvidia_smi(),
                phase_s=time.perf_counter() - t0)
    return line


# -- data-parallel training --------------------------------------------------------


def _stats_delta(a: dict, b: dict) -> dict:
    """The collectives between two ``stats`` snapshots."""
    return {"calls": {k: v - a["calls"].get(k, 0) for k, v in b["calls"].items()},
            "bytes": {k: v - a["bytes"].get(k, 0) for k, v in b["bytes"].items()},
            "seconds": b["seconds"] - a["seconds"]}


class _LocalNorm:
    """Wraps ``launch.steps.all_reduce_grads``: the first call's gradient
    norm before the mean (this rank's own gradients: its rows' where the
    data axis leaves a leaf whole, its shards' elsewhere), read once."""

    def __init__(self):
        self.real = train_steps.all_reduce_grads
        self.gnorm = None

    def __call__(self, grads, params, mesh, **kw):
        if self.gnorm is None:
            self.gnorm = float(global_norm(grads.values()))
        return self.real(grads, params, mesh, **kw)

    def __enter__(self):
        train_steps.all_reduce_grads = self
        return self

    def __exit__(self, *exc):
        train_steps.all_reduce_grads = self.real


def _rank_peak(mesh, reset: bool = False) -> int | None:
    """This rank's peak device bytes (None for CPU ranks, as in a rehearsal
    without a card); ``reset`` starts a new peak."""
    if mesh.device.type != "cuda":
        return None
    torch.cuda.synchronize()
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def _both_axes(before: dict, after: dict) -> dict:
    """``_stats_delta`` of both axes of a ``HostMesh.stats`` pair, summed."""
    out = {"calls": {}, "bytes": {}, "seconds": 0.0}
    for axis in ("data", "model"):
        d = _stats_delta(before[axis], after[axis])
        for k in ("calls", "bytes"):
            for op, v in d[k].items():
                out[k][f"{axis}/{op}"] = v
        out["seconds"] += d["seconds"]
    return out


def _counts(measured: dict, derived: dict, steps: int = 1) -> dict:
    """A case's collectives, per axis and op, against ``steps`` times the
    count ``launch.dryrun.derived_collectives`` derives for one step."""
    return {"equal": dryrun.measured_matches(measured, derived, steps), "measured": measured,
            "derived_per_step": derived, "steps": steps}


def _whole_leaf_digests(state: dict) -> dict:
    """``tensor_digest`` of this rank's copy of each parameter and moment
    that the data axis leaves whole (on TinyLlama's FSDP mesh, the norms),
    and of the step count: the same on every rank where the ranks agree.
    The FSDP shards differ by design, and gathering them whole (11 GB
    through gloo) would only add copies that the gather makes equal."""
    specs = state["params"].placement.specs
    leaves = {"params": state["params"].state_dict(), "mu": state["opt"]["mu"],
              "nu": state["opt"]["nu"]}
    out = {f"{part}/{n}": tensor_digest(t) for part, tree in leaves.items()
           for n, t in tree.items() if "data" not in specs[n]}
    _check(len(out) > 0, "train_dp lm: no leaf is whole on the data axis")
    return out | {"count": tensor_digest(state["opt"]["count"])}


def _dp_lm(mesh, seed: int, cfg, seq_len: int, n_steps: int, digests: bool = True) -> dict:
    """TinyLlama's train steps on this rank, as ``_train_lm`` runs them on
    one: the same global batches, this rank's rows taken by the step;
    ``digests``: of the final state's leaves that the data axis leaves
    whole (``_whole_leaf_digests``)."""
    bundle = build_bundle(TRAIN_LM_ARCH, "train_4k", config=cfg, mesh=mesh)
    state = bundle.init_state_fn(seed)
    tokens_spec = {"tokens": InputSpec((TRAIN_LM_BATCH, seq_len + 1), torch.int32)}
    batches = [make_batch(tokens_spec, seed=seed, step=i, bounds=bundle.input_bounds,
                          device=mesh.device) for i in range(n_steps)]
    _rank_peak(mesh, reset=True)
    _zero_flash_counts()
    before = mesh.stats()
    losses, gnorms, wall = [], [], []
    with _LocalNorm() as local:
        for b in batches:
            t0 = time.perf_counter()
            state, m = bundle.step_fn(state, b)
            losses.append(float(m["loss"]))  # waits for the step
            wall.append(time.perf_counter() - t0)
            gnorms.append(float(m["gnorm"]))
    after = mesh.stats()
    stats = _both_axes(before, after)
    res = {"losses": losses, "gnorms": gnorms, "local_gnorm_step1": local.gnorm,
           "step_s_each": wall, "stats": stats,
           "collective_share": stats["seconds"] / sum(wall),
           "peak_device_bytes": _rank_peak(mesh),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state["params"].parameters()),
           "flash_launches": flash_fwd.launches,
           "counts": _counts(dryrun.stats_delta(before, after), dryrun.derived_for(
               bundle, state["params"], mesh, batch=TRAIN_LM_BATCH, seq=seq_len), n_steps)}
    if digests:
        t0 = time.perf_counter()
        res["digests"] = _whole_leaf_digests(state)
        res["digest_s"] = time.perf_counter() - t0
    del state, batches
    _rank_peak(mesh, reset=True)
    return res


def _dp_recsys(mesh, seed: int, cfg) -> dict:
    """DeepFM's train_batch through ``train()`` on this rank."""
    _rank_peak(mesh, reset=True)
    with _LocalNorm() as local:
        out = train("deepfm", "train_batch", steps=TRAIN_DP_STEPS, reduced=False, config=cfg,
                    seed=seed, verbose=False, device=mesh.device)
    stats = out["stats"]  # the collectives of train()'s own host mesh
    res = {"losses": out["losses"], "gnorms": out["gnorms"], "local_gnorm_step1": local.gnorm,
           "step_s_each": out["step_s"], "stats": stats,
           "collective_share": stats["seconds"] / sum(out["step_s"]),
           "peak_device_bytes": _rank_peak(mesh),
           "digests": state_digests(out["final_state"])}
    del out
    _rank_peak(mesh, reset=True)
    return res


def _dp_restart(mesh, seed: int, root: str) -> dict:
    """``train()``'s checkpoints on this rank: straight, a crash and its
    resume, then the straight run continued (see TRAIN_DP_RESTART)."""
    n, every, crash_at, more = TRAIN_DP_RESTART
    kw = dict(seed=seed, verbose=False, ckpt_every=every, device=mesh.device)
    straight, crashy = f"{root}/straight", f"{root}/crashy"
    ref = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, ckpt_dir=straight, **kw)
    crash = None
    try:
        train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, ckpt_dir=crashy, crash_at=crash_at,
              **kw)
    except InjectedCrash as e:
        crash = str(e)
    crash_ckpt = latest_step(crashy)
    out = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, ckpt_dir=crashy, **kw)
    if mesh.rank == 0:  # the straight run's last checkpoint, kept for one rank
        shutil.copytree(straight, f"{root}/one")
    cont = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n + more, ckpt_dir=straight, **kw)
    return {"losses": ref["losses"], "digests": state_digests(ref["final_state"]),
            "crash": crash, "crash_checkpoint": crash_ckpt,
            "resumed_from": out["resumed_from"], "resumed_losses": out["losses"],
            "resumed_digests": state_digests(out["final_state"]),
            "continued_from": cont["resumed_from"], "continued_losses": cont["losses"]}


def _tp_prefill(mesh, seed: int, arch: str, cfg, tokens) -> dict:
    """One model's prefill_32k on this rank of the model axis: built from
    ``seed`` as the lm phase builds it, the flash launches counted from 0
    around the bundle's step, which is timed (one call: the rank's first
    of this model) and whose last position's logits (gathered whole) are
    read off it."""
    bundle = build_bundle(arch, "prefill_32k", config=cfg, mesh=mesh)
    state = bundle.init_state_fn(seed)
    model = state["params"]
    layer = (model.moe_layers if cfg.moe else model.dense_layers)[0]
    tokens = tokens.to(mesh.device)
    seen = {}
    real = train_steps.gather_logits

    def keep(model, logits, mesh):
        out = real(model, logits, mesh)
        seen["logits"] = out[:, -1].float().cpu()
        return out

    _rank_peak(mesh, reset=True)
    _zero_flash_counts()
    before = mesh.stats()
    train_steps.gather_logits = keep
    t0 = time.perf_counter()
    try:
        out = bundle.step_fn(state, {"tokens": tokens})
    finally:
        train_steps.gather_logits = real
    _rank_peak(mesh)  # the host clock up to the card's end
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after = mesh.stats()
    stats = _both_axes(before, after)
    launches, variants = flash_fwd.launches, dict(flash_fwd.variant_launches)
    res = {"arch": arch, "n_layers": cfg.n_layers, "s": int(tokens.shape[1]),
           "heads_per_rank": [layer.attn.wq.shape[1] // cfg.d_head,
                              layer.attn.wk.shape[1] // cfg.d_head],
           "experts_per_rank": layer.moe.we_gate.shape[0] if cfg.moe else None,
           "fsdp": any("data" in spec for spec in model.placement.specs.values()),
           "flash_launches": launches, "variant_launches": variants,
           "prefill_ms": prefill_ms, "stats": stats,
           "collective_share": stats["seconds"] * 1e3 / prefill_ms,
           "peak_device_bytes": _rank_peak(mesh),
           "counts": _counts(dryrun.stats_delta(before, after), dryrun.derived_for(
               bundle, model, mesh, batch=int(tokens.shape[0]), seq=int(tokens.shape[1]))),
           "next_token": out["next_token"].tolist(), "logits": seen["logits"]}
    del state, model, out
    _rank_peak(mesh, reset=True)
    return res


def _tp_recsys(mesh, seed: int, cfg) -> dict:
    """DeepFM's train_batch through ``train(model=T)`` on this rank."""
    _rank_peak(mesh, reset=True)
    with _LocalNorm() as local:
        out = train("deepfm", "train_batch", steps=TRAIN_DP_STEPS, reduced=False, config=cfg,
                    seed=seed, verbose=False, device=mesh.device, model=mesh.shape["model"])
    stats = _stats_delta({"calls": {}, "bytes": {}, "seconds": 0.0}, out["model_stats"])
    res = {"losses": out["losses"], "gnorms": out["gnorms"], "local_gnorm_step1": local.gnorm,
           "step_s_each": out["step_s"], "stats": stats,
           "collective_share": stats["seconds"] / sum(out["step_s"]),
           "peak_device_bytes": _rank_peak(mesh),
           "digests": state_digests(out["final_state"])}
    del out
    _rank_peak(mesh, reset=True)
    return res


def _tp_restart(mesh, seed: int, root: str) -> dict:
    """``train()`` on the model axis: TRAIN_DP_RESTART[0] steps of
    DeepSeek-V3's reduced config, checkpointed (whole) every
    TRAIN_DP_RESTART[1]."""
    n, every, _, _ = TRAIN_DP_RESTART
    out = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, ckpt_dir=f"{root}/tp",
                ckpt_every=every, seed=seed, verbose=False, device=mesh.device,
                model=mesh.shape["model"])
    return {"losses": out["losses"], "digests": state_digests(out["final_state"])}


def _own_partial(axis, m, l, o):
    """The serve_mesh control: the split-KV partials left unmerged, each
    rank attending its own slots alone."""
    return o / l.clamp_min(1e-30)[..., None]


def _serve_decode(mesh, seed: int, arch: str, cfg, tokens, pos0: int, cache_len: int) -> dict:
    """decode_32k on this rank of the model axis (see DECODE_REFS): the
    parameters as the serving bundles place them (the prefill bundle's
    init: the same rule), the lm phase's seeded cache cut to this rank's
    shard by the bundle's ``cache_spec``, then the bundle's step at each
    position, teacher-forced with ``tokens``; each step's logits (read off
    ``lm_decode_step``), collectives and host time; then the control.  Then
    the first DECODE_F32_STEPS positions again in float32 (the model and
    the same cache cast), and their control."""
    bundle = build_bundle(arch, "decode_32k", config=cfg, mesh=mesh)
    model = build_bundle(arch, "prefill_32k", config=cfg, mesh=mesh).init_state_fn(seed)["params"]
    spec = bundle.info["cache_spec"]
    dtype = model.embed.dtype

    def rank_cache(to):  # drawn whole in the model's dtype, as the lm phase's
        full, _ = _decode_cache(cfg, dtype, mesh.device, seed, tokens.shape[1], cache_len)
        return {k: {n: shard_of(t, tuple(spec) + (None,) * (t.dim() - 3), mesh).to(to, copy=True)
                    for n, t in v.items()} for k, v in full.items()}

    cache = rank_cache(dtype)
    _rank_peak(mesh, reset=True)
    derived = dryrun.derived_for(bundle, model, mesh, batch=int(tokens.shape[1]))
    seen = []
    real = train_steps.lm_decode_step

    def keep(*a, **kw):
        lg, c = real(*a, **kw)
        seen.append(lg[:, -1].float())
        return lg, c

    def run(state, n: int, timed: bool):
        """n steps, then the control: the last step again (the same slot
        rewritten with the same entry) with the partials left unmerged."""
        counts, stats0, wall, out = [], None, 0.0, None
        for i in range(n):
            if timed and i == 1:  # the timed steps: all but the first
                _rank_peak(mesh)
                t0, stats0 = time.perf_counter(), mesh.stats()
            before = mesh.stats()
            state, out = bundle.step_fn(state, {"tokens": tokens[i], "pos": pos0 + i})
            counts.append(dryrun.stats_delta(before, mesh.stats()))
        if timed:
            _rank_peak(mesh)
            wall = time.perf_counter() - t0
        stats = _both_axes(stats0, mesh.stats()) if timed else None
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, lm_attention, "_merge_partials",
                           lm_attention._merge_partials)
            lm_attention._merge_partials = _own_partial
            bundle.step_fn(state, {"tokens": tokens[n - 1], "pos": pos0 + n - 1})
        logits = torch.stack(seen).cpu()
        seen.clear()
        return state, out, counts, stats, wall, logits

    tokens = tokens.to(mesh.device)
    train_steps.lm_decode_step = keep
    try:
        state, out, counts, stats, wall, logits = run(
            {"params": model, "cache": cache}, tokens.shape[0], timed=True)
        cache_bytes = sum(t.numel() * t.element_size() for v in state["cache"].values()
                          for t in v.values())
        peak = _rank_peak(mesh)
        del state, cache
        t32 = time.perf_counter()
        model.float()  # the float32 run: the last use of this model
        *_, logits32 = run({"params": model, "cache": rank_cache(torch.float32)},
                           DECODE_F32_STEPS, timed=False)
        t32 = time.perf_counter() - t32
    finally:
        train_steps.lm_decode_step = real
    res = {"arch": arch, "cache_spec": [list(a) if isinstance(a, tuple) else a for a in spec],
           "cache_bytes": cache_bytes, "logits": logits[:-1], "control_logits": logits[-1],
           "logits_f32": logits32[:-1], "control_logits_f32": logits32[-1], "f32_s": t32,
           "next_token": out["next_token"].tolist(), "steps": len(counts),
           "ms_per_token": wall * 1e3 / (len(counts) - 1), "stats": stats,
           "collective_share": stats["seconds"] / wall, "peak_device_bytes": peak,
           "counts_equal": all(_counts(c, derived)["equal"] for c in counts),
           "counts": _counts(counts[-1], derived)}
    del model
    _rank_peak(mesh, reset=True)
    return res


def _serve_recsys(mesh, seed: int, cfg, retrieval: bool) -> dict:
    """DeepFM's serve_bulk (and retrieval_cand) on this rank, on the recsys
    phase's inputs (drawn from the same generator in the same order)."""
    serve = build_bundle("deepfm", "serve_bulk", config=cfg, mesh=mesh)
    state = serve.init_state_fn(seed)
    gen = _gen(mesh.device, seed + 1)
    ids = torch.randint(0, cfg.vocab_per_field, serve.abstract_inputs["ids"].shape,
                        generator=gen, device=mesh.device, dtype=torch.int32)
    _rank_peak(mesh, reset=True)
    before = mesh.stats()
    t0 = time.perf_counter()
    scores = serve.step_fn(state, {"ids": ids})["scores"]
    _rank_peak(mesh)
    ms = (time.perf_counter() - t0) * 1e3
    res = {"serve_bulk": {"scores": scores.cpu(), "ms": ms,
                          "stats": _both_axes(before, mesh.stats()),
                          "counts": _counts(dryrun.stats_delta(before, mesh.stats()),
                                            dryrun.derived_for(serve, state["params"], mesh)),
                          "peak_device_bytes": _rank_peak(mesh)}}
    if retrieval:
        rb = build_bundle("deepfm", "retrieval_cand", config=cfg, mesh=mesh)
        q_ids = torch.randint(0, cfg.vocab_per_field, rb.abstract_inputs["ids"].shape,
                              generator=gen, device=mesh.device, dtype=torch.int32)
        cands = torch.randn((rb.info["candidates"], cfg.embed_dim), generator=gen,
                            device=mesh.device)
        before = mesh.stats()
        t0 = time.perf_counter()
        top = rb.step_fn(state, {"ids": q_ids, "candidates": cands})
        _rank_peak(mesh)
        res["retrieval_cand"] = {
            "top_ids": top["top_ids"].cpu(), "top_scores": top["top_scores"].cpu(),
            "ms": (time.perf_counter() - t0) * 1e3, "stats": _both_axes(before, mesh.stats()),
            "candidates_each": rb.info["candidates"] // mesh.shape["data"],
            "counts": _counts(dryrun.stats_delta(before, mesh.stats()),
                              dryrun.derived_for(rb, state["params"], mesh))}
    del state
    _rank_peak(mesh, reset=True)
    return res


def _dryrun_cell(mesh) -> dict:
    """DRYRUN_CELL's step through ``launch.dryrun.cell_on_rank`` on this
    rank, the flash launches counted from 0 around it."""
    _zero_flash_counts()
    res = dryrun.cell_on_rank(*DRYRUN_CELL, mesh)
    return res | {"launches": flash_fwd.launches,
                  "variant_launches": dict(flash_fwd.variant_launches)}


def _gnn_step(bundle, seed: int, device) -> tuple:
    """One step of a GNN bundle from its seeded state on the seeded global
    batch of step 0 (``train()``'s first): ``(loss, gnorm, seconds)``."""
    state = bundle.init_state_fn(seed)
    inputs = bundle.abstract_inputs
    batch = graph_batch(inputs, seed=seed, step=0,
                        n_nodes=(inputs.get("x") or inputs["species"]).shape[0], device=device)
    t0 = time.perf_counter()
    state, m = bundle.step_fn(state, batch)
    loss = float(m["loss"])  # waits for the step
    return loss, float(m["gnorm"]), time.perf_counter() - t0, state


def _gnn_one_rank(device, seed: int) -> dict:
    """The one-rank step of each GNN_RANKS case (the gnn_ranks phase's
    reference), with its segment-sum launches and peak device bytes."""
    out = {}
    for arch, shape, _ in GNN_RANKS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bundle = build_bundle(arch, shape, device=device)
        (loss, gnorm, secs, state), launches = _counted(lambda: _gnn_step(bundle, seed, device))
        out[arch] = {"loss": loss, "gnorm": gnorm, "step_s": secs, "launches": launches,
                     "peak_device_bytes": torch.cuda.max_memory_allocated()}
        del state
    torch.cuda.empty_cache()
    return out


def _gnn_rank(mesh, seed: int, arch: str, shape: str) -> dict:
    """One step of a GNN_RANKS case on this rank of ``mesh``'s flattened
    axis, its collectives and segment-sum launches counted from 0 around
    it; then the control step from the same state, the partial aggregates
    left unreduced."""
    bundle = build_bundle(arch, shape, mesh=mesh)
    _rank_peak(mesh, reset=True)
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    segment_sum_sorted.launches = 0
    before = mesh.stats()
    loss, gnorm, secs, state = _gnn_step(bundle, seed, mesh.device)
    after = mesh.stats()
    launches = segment_sum_sorted.launches
    flat = _stats_delta(before["flat"], after["flat"])
    res = {"arch": arch, "shape": mesh.shape, "loss": loss, "gnorm": gnorm, "step_s": secs,
           "launches": launches, "stats": flat, "collective_share": flat["seconds"] / secs,
           "peak_device_bytes": _rank_peak(mesh),
           "counts": _counts(dryrun.stats_delta(before, after),
                             dryrun.derived_for(bundle, state["params"], mesh))}
    del state
    real = GraphShard.scatter
    GraphShard.scatter = lambda self, partial: self.block(partial)
    try:
        ctrl = _gnn_step(bundle, seed, mesh.device)
    finally:
        GraphShard.scatter = real
    res["control"] = {"loss": ctrl[0], "gnorm": ctrl[1], "step_s": ctrl[2]}
    del ctrl
    _rank_peak(mesh, reset=True)
    return res


def _dp_rank(seed: int, root: str, lm_cfg, lm_seq: int, recsys_cfg, prefill: dict,
             decode: dict) -> dict:
    """One rank of the train_dp launch: every case, at the configs the
    parent sends (the published ones on the card); then the model_axis
    cases on the same ranks as a (1, MODEL_AXIS_RANKS) mesh (``prefill``:
    arch -> (config, tokens)), then the serve_mesh cases (``decode``: arch
    -> (config, tokens, first position, cache slots)), then the gnn_ranks
    cases (GNN_RANKS, at their published configs)."""
    mesh = make_host_mesh()
    t0 = time.perf_counter()
    out = {"mesh": mesh.data.describe(), "shape": mesh.shape,
           "lm": _dp_lm(mesh, seed, lm_cfg, lm_seq, TRAIN_DP_LM_STEPS)}
    out["recsys"] = _dp_recsys(mesh, seed, recsys_cfg)
    out["restart"] = _dp_restart(mesh, seed, root)
    out["rank_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = make_mesh(data=1, model=MODEL_AXIS_RANKS)
    out["tp"] = {"shape": tp.shape, "lm": _dp_lm(tp, seed, lm_cfg, lm_seq, 1, digests=False),
                 "prefill": [_tp_prefill(tp, seed, arch, cfg, tokens)
                             for arch, (cfg, tokens) in prefill.items()],
                 "recsys": _tp_recsys(tp, seed, recsys_cfg),
                 "restart": _tp_restart(tp, seed, root),
                 "rank_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["serve_mesh"] = {
        "decode": [_serve_decode(tp, seed, arch, cfg, tokens, pos0, cache_len)
                   for arch, (cfg, tokens, pos0, cache_len) in decode.items()],
        "recsys": {"2x1": _serve_recsys(mesh, seed, recsys_cfg, retrieval=True),
                   "1x2": _serve_recsys(tp, seed, recsys_cfg, retrieval=False)},
        "dryrun_cell": _dryrun_cell(tp),
        "rank_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    meshes = {(2, 1): mesh, (1, 2): tp}
    out["gnn_ranks"] = {"cases": [_gnn_rank(meshes[dims], seed, arch, shape)
                                  for arch, shape, dims in GNN_RANKS],
                        "rank_s": time.perf_counter() - t0}
    return out


def _dp_off(got: dict, ref: dict, step: int) -> dict:
    """Each gated value's relative distance at ``step`` (0-based)."""
    key = {"loss": "losses", "gnorm": "gnorms"}
    return {k: abs(got[key[k]][step] - ref[key[k]][step]) / abs(ref[key[k]][step])
            for k in TRAIN_DP_RTOL}


def _held(case: str, got: dict, ref: dict, steps: int, ranks, key,
          rtol: dict = TRAIN_DP_RTOL) -> dict:
    """A rank launch's train case against the one-rank run ``ref``: each
    of ``steps`` steps within ``rtol``, the control (rank 0's gradient norm
    before the cross-rank sums) outside it, and, where the ranks took
    digests, every rank's digests equal."""
    off = [_dp_off(got, ref, i) for i in range(steps)]
    ctrl = abs(got["local_gnorm_step1"] - ref["gnorms"][0]) / abs(ref["gnorms"][0])
    _check(all(o[k] <= rtol[k] for o in off for k in o),
           f"{case}: off the one-rank step by {off} (bound {rtol})")
    _check(ctrl > rtol["gnorm"],
           f"{case}: the control (rank 0's gradient norm before the sums) passed: {ctrl}")
    identical = None
    if "digests" in got:
        identical = all(key(r)["digests"] == got["digests"] for r in ranks)
        _check(identical, f"{case}: the ranks' states differ")
    return {k: v for k, v in got.items() if k != "digests"} | {
        "one_rank": {"losses": ref["losses"][:steps], "gnorms": ref["gnorms"][:steps]},
        "off": off, "control_off": ctrl, "ranks_identical": identical,
        "peak_device_bytes_each": [key(r)["peak_device_bytes"] for r in ranks],
        "step_s": float(np.median(got["step_s_each"][1:] or got["step_s_each"]))}


def phase_train_dp(device, seed: int, train_line: dict) -> tuple[dict, dict, dict, dict]:
    """Data-parallel training on ranks sharing the card (see TRAIN_DP_*),
    then the model_axis cases on the same ranks (see MODEL_AXIS_RANKS), the
    serve_mesh cases and the gnn_ranks cases; ``train_line`` is the train
    phase's, the one-rank values, PREFILL_REFS, DECODE_REFS and RECSYS_REFS
    the lm and recsys phases', and GNN_REFS is filled here first.  Returns
    the four phases' lines."""
    t0 = time.perf_counter()
    GNN_REFS.update(_gnn_one_rank(device, seed))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        lm = ARCHS[TRAIN_LM_ARCH]
        prefill = {arch: (cfg, tokens) for arch, (cfg, tokens, _) in PREFILL_REFS.items()}
        decode = {arch: ref[:4] for arch, ref in DECODE_REFS.items()}
        ranks = run_ranks(_dp_rank, TRAIN_DP_RANKS, device=device.type,
                          timeout=TRAIN_DP_TIMEOUT_S,
                          args=(seed, root, lm.config, lm.shapes()["train_4k"].seq_len,
                                ARCHS["deepfm"].config, prefill, decode))
        launch_s = time.perf_counter() - t0
        r0 = ranks[0]
        line = {"ranks": TRAIN_DP_RANKS, "backend": ranks.backend, "devices": ranks.devices,
                "mesh": r0["mesh"], "shape": r0["shape"], "launch_s": launch_s,
                "rank_s": [r["rank_s"] for r in ranks]}
        _check(r0["shape"] == {"data": TRAIN_DP_RANKS, "model": 1},
               f"train_dp: the host mesh is {r0['shape']}")
        line["lm"] = _held("train_dp lm", r0["lm"], train_line["lm"], TRAIN_DP_LM_STEPS, ranks,
                           lambda r: r["lm"])
        line["lm"].update(rtol=TRAIN_DP_RTOL, fsdp=True,
                          cut={"steps": [TRAIN_DP_STEPS, TRAIN_DP_LM_STEPS]})
        line["recsys"] = _held("train_dp recsys", r0["recsys"], train_line["recsys"],
                               TRAIN_DP_STEPS, ranks, lambda r: r["recsys"])
        _check(line["lm"]["flash_launches"] == 0, "train_dp lm: the flash kernel ran under grad")
        _check_counts("train_dp lm", [r["lm"]["counts"] for r in ranks])

        # -- the restart across rank counts --
        n, every, crash_at, more = TRAIN_DP_RESTART
        rs = r0["restart"]
        _check(all(r["restart"] == rs for r in ranks), "train_dp restart: the ranks disagree")
        _check(rs["crash"] == f"injected crash at step {crash_at}"
               and rs["crash_checkpoint"] == every and rs["resumed_from"] == every,
               f"train_dp restart: crash {rs['crash']!r}, checkpoint {rs['crash_checkpoint']}")
        _check(rs["resumed_losses"] == rs["losses"][every:]
               and rs["resumed_digests"] == rs["digests"],
               "train_dp restart: the 2-rank resume differs from the straight run")
        _check(rs["continued_from"] == n,
               f"train_dp restart: the 2-rank continuation resumed from {rs['continued_from']}")
        # one rank resumes the 2-rank checkpoint: with no step left to run,
        # its final state is the restored one
        kw = dict(ckpt_dir=f"{root}/one", seed=seed, verbose=False, device=device, ranks=1)
        restored = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, **kw)
        _check(restored["resumed_from"] == n and not restored["losses"]
               and state_digests(restored["final_state"]) == rs["digests"],
               "train_dp restart: one rank restored another state than the 2 ranks'")
        del restored
        one = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n + more, **kw)
        one_off = [abs(a - b) / abs(b) for a, b in zip(one["losses"], rs["continued_losses"])]
        _check(one["resumed_from"] == n,
               f"train_dp restart: one rank resumed from {one['resumed_from']}, not {n}")
        _check(all(o <= TRAIN_DP_RESTART_RTOL for o in one_off),
               f"train_dp restart: one rank's losses off the 2 ranks' by {one_off}")
        line["restart"] = {
            "arch": TRAIN_DP_RESTART_ARCH, "config": "reduced", "steps": n, "ckpt_every": every,
            "crash_at": crash_at, "losses": rs["losses"], "resumed_losses": rs["resumed_losses"],
            "bit_exact": True, "one_rank": {"from": n, "losses": one["losses"],
                                            "two_rank_losses": rs["continued_losses"],
                                            "off": one_off, "rtol": TRAIN_DP_RESTART_RTOL,
                                            "restored_bit_exact": True}}
        del one
        tp_line = _model_axis_line(ranks, train_line, device, seed, root)
    line.update(nvidia_smi=_nvidia_smi(), phase_s=time.perf_counter() - t0)
    tp_line["nvidia_smi"] = line["nvidia_smi"]
    serve_line = _serve_mesh_line(ranks, device.type == "cuda")
    serve_line["nvidia_smi"] = line["nvidia_smi"]
    gnn_line = _gnn_ranks_line(ranks, device.type == "cuda")
    gnn_line["nvidia_smi"] = line["nvidia_smi"]
    return line, tp_line, serve_line, gnn_line


def _gnn_ranks_line(ranks, on_card: bool) -> dict:
    """The gnn_ranks cases of the launch ``ranks``, held against GNN_REFS
    (see GNN_RANKS; a CPU rehearsal launches no kernel)."""
    line = {"ranks": TRAIN_DP_RANKS, "rank_s": [r["gnn_ranks"]["rank_s"] for r in ranks],
            "cases": []}
    for i, (arch, shape, dims) in enumerate(GNN_RANKS):
        each = [r["gnn_ranks"]["cases"][i] for r in ranks]
        ref = GNN_REFS[arch]
        off = {k: max(abs(p[k] - ref[k]) / abs(ref[k]) for p in each) for k in TRAIN_DP_RTOL}
        ctrl = {k: min(abs(p["control"][k] - ref[k]) / abs(ref[k]) for p in each)
                for k in TRAIN_DP_RTOL}
        case = f"gnn_ranks {arch} {dims}"
        _check(all(off[k] <= TRAIN_DP_RTOL[k] for k in off),
               f"{case}: off the one-rank step by {off} (bound {TRAIN_DP_RTOL})")
        _check(any(ctrl[k] > TRAIN_DP_RTOL[k] for k in ctrl),
               f"{case}: the control (the partial aggregates unreduced) passed: {ctrl}")
        _check(not on_card or all(p["launches"] > 0 for p in each),
               f"{case}: a rank launched the segment-sum kernel no time: "
               f"{[p['launches'] for p in each]}")
        _check_counts(case, [p["counts"] for p in each])
        cfg = ARCHS[arch].config
        p0 = each[0]
        line["cases"].append({
            "arch": arch, "shape": shape, "mesh": p0["shape"], "layers": cfg.n_layers,
            "d_hidden": cfg.d_hidden, "one_rank": ref, "loss_each": [p["loss"] for p in each],
            "gnorm_each": [p["gnorm"] for p in each], "off": off, "control_off": ctrl,
            "rtol": TRAIN_DP_RTOL, "step_s_each": [p["step_s"] for p in each],
            "control_step_s_each": [p["control"]["step_s"] for p in each],
            "launches_each": [p["launches"] for p in each],
            "stats_each": [p["stats"] for p in each],
            "collective_share_each": [p["collective_share"] for p in each],
            "peak_device_bytes_each": [p["peak_device_bytes"] for p in each],
            "counts_per_step": p0["counts"]["derived_per_step"], "counts_equal": True})
    line["launches"] = sum(sum(c["launches_each"]) for c in line["cases"])
    return line


def _check_counts(case: str, counts: list) -> None:
    """Every rank's measured collectives equal the derived count."""
    for r, c in enumerate(counts):
        _check(c["equal"], f"{case}: rank {r}'s collectives {c['measured']} are not the "
                           f"derived {c['derived_per_step']} x {c['steps']}")


def _serve_mesh_line(ranks, on_card: bool) -> dict:
    """The serve_mesh cases of the launch ``ranks``, held (see DECODE_REFS
    and DRYRUN_CELL; a CPU rehearsal launches no flash kernel)."""
    line = {"ranks": TRAIN_DP_RANKS, "rank_s": [r["serve_mesh"]["rank_s"] for r in ranks],
            "decode": []}
    for i, (arch, (cfg, tokens, pos0, cache_len, ref, ref32)) in enumerate(DECODE_REFS.items()):
        each = [r["serve_mesh"]["decode"][i] for r in ranks]
        held = {}
        for key, want, bound in (("", ref, DECODE_MESH_BF16_SHARE),
                                 ("_f32", ref32, DECODE_MESH_F32_SHARE)):
            rms = want.square().mean(dim=(1, 2)).sqrt()  # each step's
            share = max(float(((p["logits" + key] - want).abs().amax(dim=(1, 2)) / rms).max())
                        for p in each)
            ctrl = min(float((p["control_logits" + key] - want[-1]).abs().max() / rms[-1])
                       for p in each)
            _check(all(bool(torch.isfinite(p["logits" + key]).all()) for p in each)
                   and share <= bound,
                   f"serve_mesh {arch}{key}: decode logits off one rank's by {share} of their "
                   f"rms (bound {bound})")
            _check(ctrl > bound, f"serve_mesh {arch}{key}: the control (the partials "
                                 f"unmerged) passed: {ctrl} <= {bound}")
            held[key] = share, ctrl
        _check(all(p["counts_equal"] for p in each),
               f"serve_mesh {arch}: a decode step's collectives are not the derived count")
        same = all(p["next_token"] == ref[-1].argmax(-1).tolist() for p in each)
        p0 = each[0]
        line["decode"].append({
            "arch": arch, "mesh": {"data": 1, "model": TRAIN_DP_RANKS},
            "batch": int(tokens.shape[1]), "cache_len": cache_len,
            "positions": [pos0, pos0 + p0["steps"] - 1], "cache_spec": p0["cache_spec"],
            "ms_per_token_each": [p["ms_per_token"] for p in each],
            "stats": p0["stats"], "collective_share": p0["collective_share"],
            "cache_bytes_each": [p["cache_bytes"] for p in each],
            "peak_device_bytes_each": [p["peak_device_bytes"] for p in each],
            "logit_share": held[""][0], "bound_share": DECODE_MESH_BF16_SHARE,
            "control_share": held[""][1], "f32_steps": DECODE_F32_STEPS,
            "logit_share_f32": held["_f32"][0], "bound_share_f32": DECODE_MESH_F32_SHARE,
            "control_share_f32": held["_f32"][1], "f32_s_each": [p["f32_s"] for p in each],
            "same_last_token": same, "counts_per_step": p0["counts"]["derived_per_step"],
            "cut": {"batch": [ARCHS[arch].shapes()["decode_32k"].global_batch,
                              int(tokens.shape[1])]}})
    line["recsys"] = {}
    for key in ("2x1", "1x2"):
        each = [r["serve_mesh"]["recsys"][key] for r in ranks]
        err = max(_max_abs_err(p["serve_bulk"]["scores"], RECSYS_REFS["scores"]) for p in each)
        _check(err <= RECSYS_SCORE_TOL, f"serve_mesh deepfm {key}: scores off one rank's by {err}")
        _check_counts(f"serve_mesh deepfm serve_bulk {key}",
                      [p["serve_bulk"]["counts"] for p in each])
        case = {"serve_bulk": {"max_abs_err": err, "tol": RECSYS_SCORE_TOL,
                               "ms_each": [p["serve_bulk"]["ms"] for p in each],
                               "stats": each[0]["serve_bulk"]["stats"],
                               "peak_device_bytes_each": [p["serve_bulk"]["peak_device_bytes"]
                                                          for p in each],
                               "counts": each[0]["serve_bulk"]["counts"]["derived_per_step"]}}
        if "retrieval_cand" in each[0]:
            got = [p["retrieval_cand"] for p in each]
            same = all(torch.equal(g["top_ids"], RECSYS_REFS["top_ids"]) for g in got)
            s_err = max(_max_abs_err(g["top_scores"], RECSYS_REFS["top_scores"]) for g in got)
            _check(same and s_err <= RECSYS_SCORE_TOL,
                   f"serve_mesh deepfm {key}: retrieval's top ids differ ({same}) or scores "
                   f"off by {s_err}")
            _check_counts(f"serve_mesh deepfm retrieval_cand {key}", [g["counts"] for g in got])
            case["retrieval_cand"] = {"same_top_ids": same, "max_abs_err": s_err,
                                      "candidates_each": got[0]["candidates_each"],
                                      "ms_each": [g["ms"] for g in got],
                                      "stats": got[0]["stats"],
                                      "counts": got[0]["counts"]["derived_per_step"]}
        line["recsys"][key] = case
    cell = [r["serve_mesh"]["dryrun_cell"] for r in ranks]
    n_layers = reduced_config(ARCHS[DRYRUN_CELL[0]]).n_layers
    _check_counts(f"serve_mesh dry-run cell {DRYRUN_CELL}",
                  [_counts(c["measured"], c["derived"]) for c in cell])
    _check(not on_card or all(c["launches"] == n_layers for c in cell),
           f"serve_mesh dry-run cell {DRYRUN_CELL}: a rank launched flash "
           f"{[c['variant_launches'] for c in cell]}, not once in each of {n_layers} layers")
    line["dryrun_cell"] = {"arch": DRYRUN_CELL[0], "shape": DRYRUN_CELL[1], "config": "reduced",
                           "n_layers": n_layers, "mesh": cell[0]["shape"],
                           "flash_launches_each": [c["launches"] for c in cell],
                           "variant_launches": cell[0]["variant_launches"],
                           "counts_per_step": cell[0]["derived"], "counts_equal": True}
    line["launches"] = sum(c["launches"] for c in cell)
    return line


def phase_dryrun() -> dict:
    """``launch.dryrun``'s reckoning of every cell at both production
    meshes, on the host (no card work), beside this card's memory: the
    reference's "does it fit" question for an H100.  Not a gate."""
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    cells, skipped = [], 0
    for arch, shape, kind, rec in dryrun.reckon_all():
        if kind is None:
            skipped += 1
        else:
            st = rec["state_bytes_per_rank"]
            cells.append({"arch": arch, "shape": shape, "mesh": kind,
                          "state_bytes_per_rank": st,
                          "wire_bytes_per_device": rec["collectives"]["wire_bytes_per_device"],
                          "collective_calls": sum(rec["collectives"]["counts"].values()),
                          "state_fits_card": st["total"] <= total})
    return {"card_total_memory": total, "cells": cells, "skipped": skipped,
            "not_reckoned": dryrun.NOT_RECKONED, "reckon_s": time.perf_counter() - t0}


def _model_axis_line(ranks, train_line: dict, device, seed: int, root: str) -> dict:
    """The model_axis cases of the launch ``ranks``, held (see
    MODEL_AXIS_RANKS); the (1, 2) checkpoint restored here on one rank."""
    tp0 = ranks[0]["tp"]
    _check(tp0["shape"] == {"data": 1, "model": MODEL_AXIS_RANKS},
           f"model_axis: the mesh is {tp0['shape']}")
    line = {"ranks": MODEL_AXIS_RANKS, "shape": tp0["shape"],
            "rank_s": [r["tp"]["rank_s"] for r in ranks]}
    line["lm"] = _held("model_axis lm", tp0["lm"], train_line["lm"], 1, ranks,
                       lambda r: r["tp"]["lm"], MODEL_AXIS_LM_RTOL)
    _check_counts("model_axis lm", [r["tp"]["lm"]["counts"] for r in ranks])
    line["lm"]["rtol"] = MODEL_AXIS_LM_RTOL
    _check(line["lm"]["flash_launches"] == 0, "model_axis lm: the flash kernel ran under grad")
    line["recsys"] = _held("model_axis recsys", tp0["recsys"], train_line["recsys"],
                           TRAIN_DP_STEPS, ranks, lambda r: r["tp"]["recsys"])
    line["prefill"] = []
    on_card = device.type == "cuda"
    for i, (arch, (cfg, tokens, ref)) in enumerate(PREFILL_REFS.items()):
        each = [r["tp"]["prefill"][i] for r in ranks]
        bound = LM_BF16_LOGIT_SHARE * float(ref.square().mean().sqrt())
        errs = [_max_abs_err(p["logits"], ref) for p in each]
        for p in each:
            # on the card every rank runs the kernel on its heads, one launch
            # a layer (a CPU rehearsal runs the plain path: no launches)
            _check(not on_card or (p["flash_launches"] == cfg.n_layers
                                   and p["variant_launches"]["bfloat16-wgmma"] == cfg.n_layers),
                   f"model_axis {arch}: a rank launched flash {p['variant_launches']}, "
                   f"not {cfg.n_layers} x bfloat16-wgmma")
            _check(p["heads_per_rank"] == [cfg.n_heads // MODEL_AXIS_RANKS,
                                           cfg.n_kv_heads // MODEL_AXIS_RANKS]
                   and (not cfg.moe
                        or p["experts_per_rank"] == cfg.moe.n_experts // MODEL_AXIS_RANKS),
                   f"model_axis {arch}: a rank holds {p['heads_per_rank']} heads and "
                   f"{p['experts_per_rank']} experts")
        _check(all(bool(torch.isfinite(p["logits"]).all()) for p in each)
               and max(errs) <= bound,
               f"model_axis {arch}: the prefill's logits off one rank's by {max(errs)} (> {bound})")
        _check_counts(f"model_axis {arch} prefill", [p["counts"] for p in each])
        p0 = each[0]
        line["prefill"].append({
            **{k: p0[k] for k in ("arch", "n_layers", "s", "heads_per_rank", "experts_per_rank",
                                  "fsdp", "variant_launches", "stats", "collective_share")},
            "counts_per_step": p0["counts"]["derived_per_step"],
            "flash_launches_each": [p["flash_launches"] for p in each],
            "prefill_ms_each": [p["prefill_ms"] for p in each],
            "peak_device_bytes_each": [p["peak_device_bytes"] for p in each],
            "max_abs_err": max(errs), "bound": bound, "tol_ratio": max(errs) / bound,
            "same_next_token": all(p["next_token"] == ref.argmax(-1).tolist() for p in each)})
    # the (1, 2) checkpoint restored on one rank: with no step left to run,
    # its final state is the restored one
    n = TRAIN_DP_RESTART[0]
    rs = tp0["restart"]
    _check(all(r["tp"]["restart"] == rs for r in ranks), "model_axis restart: ranks disagree")
    restored = train(TRAIN_DP_RESTART_ARCH, "train_4k", steps=n, ckpt_dir=f"{root}/tp",
                     seed=seed, verbose=False, device=device, ranks=1)
    _check(restored["resumed_from"] == n and not restored["losses"]
           and state_digests(restored["final_state"]) == rs["digests"],
           "model_axis restart: one rank restored another state than the (1, 2) ranks'")
    line["restart"] = {"arch": TRAIN_DP_RESTART_ARCH, "config": "reduced", "steps": n,
                       "losses": rs["losses"], "restored_on_one_rank_bit_exact": True}
    line["launches"] = sum(sum(p["flash_launches_each"]) for p in line["prefill"])
    return line


def build_graph(scale: int, parts: int) -> tuple[object, dict]:
    """The LIVJ-shaped graph and its partition, with host build times."""
    t0 = time.perf_counter()
    g = rmat_graph(scale, 8, seed=42)
    t1 = time.perf_counter()
    pg = bfs_grow_partition(g, parts, seed=1)
    t2 = time.perf_counter()
    layout = partitioned_edge_layout(pg)
    t3 = time.perf_counter()
    info = {
        "scale": scale,
        "n_vertices": g.n_vertices,
        "n_edges": g.n_edges,
        "n_parts": parts,
        "e_local": layout.local.n_edges,
        "e_remote": layout.remote.n_edges,
        # the longest span one warp of the relax kernel walks alone
        "max_in_degree_local": int(np.bincount(layout.local.dst, minlength=1).max()),
        "max_in_degree_remote": int(np.bincount(layout.remote.dst, minlength=1).max()),
        "edge_cut": pg.edge_cut_fraction,
        "rmat_s": t1 - t0,
        "partition_s": t2 - t1,
        "layout_s": t3 - t2,
    }
    return pg, info


# -- the GNN stack --------------------------------------------------------------


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _init_gen(seed: int) -> torch.Generator:
    """The models draw their parameters on the CPU from this generator."""
    return torch.Generator().manual_seed(seed)


def _counted(fn):
    """``fn()`` with the segment-sum launch count at 0 just before and read
    just after; returns (result, launches)."""
    torch.cuda.synchronize()
    segment_sum_sorted.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, segment_sum_sorted.launches


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|)."""
    return _max_abs_err(a, b) / max(1.0, float(b.abs().max()))


def _gnn_pna_full(device, seed: int, scale: int) -> tuple[dict, dict]:
    """PNA at its full config, full-batch over ogbn-products' size: the
    forward on ``cuda`` (counted, timed, its peak), then on ``torch``, and
    the kernel held and timed at the forward's ``[E, 75]`` message."""
    cfg = ARCHS["pna"].config
    shape = GRAPH_SHAPES["ogb_products"]
    _check((shape.n_nodes, shape.n_edges) == (OGBN_PRODUCTS_N, OGBN_PRODUCTS_E),
           "ogb_products in configs/base.py is not ogbn-products' published size")
    n, e = OGBN_PRODUCTS_N >> _cut(scale), OGBN_PRODUCTS_E >> _cut(scale)
    t0 = time.perf_counter()
    gen = _gen(device, seed + 10)
    src = torch.randint(0, n, (e,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=device, dtype=torch.int32)
    x = torch.randn((n, shape.d_feat), generator=gen, device=device)
    model = PNA(cfg, shape.d_feat, GNN_CLASSES, generator=_init_gen(seed), device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    edges = sort_edges(src, dst, n)
    del src, dst
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t1
    torch.cuda.empty_cache()
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        out, launches = _counted(lambda: model(x, edges, backend="cuda"))
        peak = torch.cuda.max_memory_allocated()
        _check(launches > 0, "PNA launched the segment-sum kernel no time")
        _check(out.shape == (n, GNN_CLASSES) and bool(torch.isfinite(out).all()),
               "PNA's output is not finite [N, 64]")
        ms = _median_ms(lambda: model(x, edges, backend="cuda"), 3)
        plain = model(x, edges, backend="torch")
        err = _rel_err(out, plain)
        _check(err <= GNN_ATOL, f"PNA on cuda differs from torch by {err} (> {GNN_ATOL})")
        del plain
        plain_ms = _median_ms(lambda: model(x, edges, backend="torch"), 3)
        profile = _profile(lambda: model(x, edges, backend="cuda"))
        # the kernel at the forward's own call: layer 0's messages
        m = model.layers[0].msg(model.encode(x)).index_select(0, edges.src)
        del out
        torch.cuda.empty_cache()
        k_out = sorted_segment_sum(edges.dst, m, n, assume_sorted=True)
        case = _seg_case("pna_message", k_out, edges.dst, m, n)
    del m, k_out, x, edges, model
    torch.cuda.empty_cache()
    line = {
        "config": {"layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                   "aggregators": list(cfg.extra["aggregators"]),
                   "scalers": list(cfg.extra["scalers"])},
        "N": n, "E": e, "d_in": shape.d_feat, "d_out": GNN_CLASSES, "cut": _cut(scale) > 0,
        "launches": launches, "forward_ms": ms, "forward_ms_torch": plain_ms,
        "peak_device_bytes": peak, "max_err_vs_torch": err, "atol": GNN_ATOL,
        "setup_s": t1 - t0, "sort_edges_s": sort_s, "profile": profile,
    }
    return line, case


def _profile(fn, kernel: str = "segment_sum_level_kernel",
             key: str = "segment_sum_kernel_ms") -> dict:
    """One call under ``torch.profiler``: the card's busy share of its wall
    time (a lower bound: the profiler lengthens the wall), the device time
    of the kernels whose name holds ``kernel`` (under ``key``) and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    kernel_ms = sum(r[1] for r in rows if kernel in r[0])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            key: kernel_ms,
            "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:10]]}


def _gnn_pna_grads(device, seed: int) -> dict:
    """PNA's full config at full_graph_sm's size: the grads of
    tests/test_archs_gnn.py's loss through the autograd entry (kernel
    forward, gather backward) against the plain version's (see GRAD_SHARE),
    and the entry's own gradient at the model's message shape, exactly."""
    cfg = ARCHS["pna"].config
    shape = GRAPH_SHAPES["full_graph_sm"]
    n, e = shape.n_nodes, shape.n_edges
    gen = _gen(device, seed + 11)
    src = torch.randint(0, n, (e,), generator=gen, device=device)
    dst = torch.randint(0, n, (e,), generator=gen, device=device)
    x = torch.randn((n, shape.d_feat), generator=gen, device=device)
    labels = torch.randint(0, GNN_CLASSES, (n,), generator=gen, device=device)
    perm = torch.randperm(e, generator=gen, device=device)
    grads, launches = {}, {}
    # deterministic scatters (index_add_ and the gathers' backward), so the
    # comparison reads the same in every run; ops without a deterministic
    # version are listed, not refused
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for run, backend, order in (("cuda", "cuda", None), ("torch", "torch", None),
                                        ("torch_reordered", "torch", perm)):
                model = PNA(cfg, shape.d_feat, GNN_CLASSES, generator=_init_gen(seed),
                            device=device)
                s_e, d_e = (src, dst) if order is None else (src[order], dst[order])

                def step():
                    lg = model(x, s_e, d_e, backend=backend)
                    loss = -torch.log_softmax(lg, -1)[torch.arange(n, device=device),
                                                      labels].mean()
                    loss.backward()
                    return loss.item()

                _, launches[run] = _counted(step)
                grads[run] = {k: p.grad for k, p in model.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    nondeterministic = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                               if "deterministic" in str(w.message)})
    _check(launches["cuda"] > 0, "PNA's grad step launched the segment-sum kernel no time")
    worst, spread, outside = 0.0, 0.0, 0
    for k, g_plain in grads["torch"].items():
        g = grads["cuda"][k]
        _check(bool(torch.isfinite(g).all()), f"PNA grad {k} is not finite")
        scale = float(g_plain.abs().max())
        share = _max_abs_err(g, g_plain) / scale
        _check(share <= GRAD_SHARE, f"PNA grad {k} on cuda differs from torch by {share} of "
                                    f"its largest |grad| (> {GRAD_SHARE})")
        worst = max(worst, share)
        spread = max(spread, _max_abs_err(grads["torch_reordered"][k], g_plain) / scale)
        outside += int((~torch.isclose(g, g_plain, rtol=1e-3, atol=1e-5)).sum())
    # the entry's backward at the message shape: the gather, bit for bit
    edges = sort_edges(src, dst, n)
    m = torch.randn((e, cfg.d_hidden), generator=gen, device=device, requires_grad=True)
    up = torch.randn((n, cfg.d_hidden), generator=gen, device=device)
    (segment_sum(edges.dst, m, n, sorted_ids=True, backend="cuda") * up).sum().backward()
    _check(torch.equal(m.grad, up[edges.dst]), "the segment-sum entry's gradient is not up[ids]")
    return {"N": n, "E": e, "d_in": shape.d_feat, "launches": launches["cuda"],
            "params": len(grads["cuda"]), "max_err_share_vs_torch": worst,
            "grad_share": GRAD_SHARE, "plain_order_spread_share": spread,
            "nondeterministic_ops": nondeterministic,
            "elements_outside_rtol_1e-3_atol_1e-5": outside,
            "elements": sum(g.numel() for g in grads["cuda"].values()),
            "entry_gradient_exact": True}


def _molecules(seed: int, device):
    """The ``molecule`` batch: 128 molecules of 30 atoms and 64 directed
    edges each, positions within MACE's and DimeNet's cutoff, and 256
    padded triplets a molecule."""
    shape = GRAPH_SHAPES["molecule"]
    g, a, m = shape.batch_graphs, shape.n_nodes, shape.n_edges
    rng = np.random.default_rng(seed + 12)
    pos = (rng.standard_normal((g * a, 3)) * 1.5).astype(np.float32)
    species = rng.integers(0, ARCHS["mace"].config.extra["n_species"], g * a).astype(np.int32)
    pairs = np.array([(i, j) for i in range(a) for j in range(a) if i != j])
    src, dst, kj, ji, tmask = [], [], [], [], []
    for k in range(g):
        pick = pairs[rng.choice(len(pairs), m, replace=False)]
        s, d = pick[:, 0].astype(np.int32), pick[:, 1].astype(np.int32)
        t_kj, t_ji, t_mask = build_triplets(s, d, MOL_TRIPLETS)
        src.append(s + k * a)
        dst.append(d + k * a)
        kj.append(t_kj + k * m)
        ji.append(t_ji + k * m)
        tmask.append(t_mask)

    def t(v):
        return torch.as_tensor(np.concatenate(v) if isinstance(v, list) else v, device=device)

    return {"pos": pos, "species": t(species), "src": t(src), "dst": t(dst),
            "kj": t(kj), "ji": t(ji), "trip_mask": t(tmask),
            "graph_id": t(np.repeat(np.arange(g, dtype=np.int32), a)), "n_graphs": g,
            "N": g * a, "E": g * m, "T": g * MOL_TRIPLETS,
            "real_triplets": int(np.concatenate(tmask).sum())}


def _gnn_molecules(device, seed: int) -> dict:
    """MACE and DimeNet at their full configs on the molecule batch: the
    ``cuda`` backend against ``torch``, and the energies under two
    rotations on the card."""
    mol = _molecules(seed, device)
    mace = MACE(ARCHS["mace"].config, generator=_init_gen(seed), device=device)
    dimenet = DimeNet(ARCHS["dimenet"].config, generator=_init_gen(seed), device=device)
    runs = {
        "mace": lambda pos, backend: mace(
            mol["species"], pos, mol["src"], mol["dst"], graph_id=mol["graph_id"],
            n_graphs=mol["n_graphs"], backend=backend),
        "dimenet": lambda pos, backend: dimenet(
            mol["species"], pos, mol["src"], mol["dst"], mol["kj"], mol["ji"],
            trip_mask=mol["trip_mask"], graph_id=mol["graph_id"], n_graphs=mol["n_graphs"],
            backend=backend)[:, 0],
    }
    pos = torch.as_tensor(mol["pos"], device=device)
    out = {"N": mol["N"], "E": mol["E"], "T": mol["T"], "graphs": mol["n_graphs"],
           "real_triplets": mol["real_triplets"]}
    with torch.inference_mode():
        for name, run in runs.items():
            energy, launches = _counted(lambda: run(pos, "cuda"))
            _check(launches > 0, f"{name} launched the segment-sum kernel no time")
            _check(energy.shape == (mol["n_graphs"],) and bool(torch.isfinite(energy).all()),
                   f"{name}'s energies are not finite [{mol['n_graphs']}]")
            scale = float(energy.abs().max())
            rel = _max_abs_err(energy, run(pos, "torch")) / scale
            _check(rel <= ENERGY_RTOL, f"{name} on cuda differs from torch ({rel})")
            rot = []
            for angle, axis in ROTATIONS:
                r = torch.as_tensor(e3.rotation_matrix(np.array(axis), angle),
                                    dtype=torch.float32, device=device)
                turned = run(pos @ r.T + (5.0 if name == "mace" else 0.0), "cuda")
                rot.append(_max_abs_err(turned, energy) / scale)
                _check(rot[-1] <= ROT_RTOL, f"{name} is not invariant under rotation ({rot[-1]})")
            out[name] = {"launches": launches, "max_err_vs_torch": rel,
                         "rotation_max_err": rot, "energy_abs_max": scale,
                         "ms": _median_ms(lambda: run(pos, "cuda"), 3),
                         "ms_torch": _median_ms(lambda: run(pos, "torch"), 3)}
    out["mace"]["kernel_call"] = [mol["E"], 9 * ARCHS["mace"].config.d_hidden]
    out["rtol"], out["rotation_rtol"] = ENERGY_RTOL, ROT_RTOL
    return out


def _gnn_meshgraphnet(pg, device, seed: int) -> dict:
    """MeshGraphNet at its full config on one minibatch_lg batch sampled
    from the LIVJ graph: one edge list over the batch's node slots."""
    cfg = ARCHS["meshgraphnet"].config
    shape = GRAPH_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    g = pg.graph
    seeds = np.random.default_rng(seed + 13).choice(g.n_vertices, shape.batch_nodes,
                                                    replace=False)
    batch = NeighborSampler(g, shape.fanout, seed=seed).sample(seeds)
    slots = [batch.blocks[-1].dst_nodes] + [blk.src_nodes for blk in reversed(batch.blocks)]
    starts = np.cumsum([0] + [s.size for s in slots])
    blocks = list(reversed(batch.blocks))  # seed side first
    src = np.concatenate([b.edge_src + starts[h + 1] for h, b in enumerate(blocks)])
    dst = np.concatenate([b.edge_dst + starts[h] for h, b in enumerate(blocks)])
    mask = np.concatenate([b.edge_mask for b in blocks])
    nodes = np.concatenate(slots)
    sample_s = time.perf_counter() - t0
    # one feature row per distinct node, read by every slot that holds it
    uniq, inv = np.unique(nodes, return_inverse=True)
    gen = _gen(device, seed + 14)
    feats = torch.randn((uniq.size, shape.d_feat), generator=gen, device=device)
    x = feats[torch.as_tensor(inv, device=device)]
    e_feat = torch.randn((src.size, cfg.extra["d_edge_feat"]), generator=gen, device=device)
    src_t, dst_t = torch.as_tensor(src, device=device), torch.as_tensor(dst, device=device)
    mask_t = torch.as_tensor(mask, device=device)
    model = MeshGraphNet(cfg, shape.d_feat, cfg.extra["d_edge_feat"], GNN_CLASSES,
                         generator=_init_gen(seed), device=device)

    def run(backend):
        return model(x, e_feat, src_t, dst_t, edge_mask=mask_t, backend=backend)

    with torch.inference_mode():
        out, launches = _counted(lambda: run("cuda"))
        _check(launches > 0, "MeshGraphNet launched the segment-sum kernel no time")
        _check(out.shape == (nodes.size, GNN_CLASSES) and bool(torch.isfinite(out).all()),
               "MeshGraphNet's output is not finite")
        err = _rel_err(out, run("torch"))
        _check(err <= GNN_ATOL, f"MeshGraphNet on cuda differs from torch by {err}")
        ms, plain_ms = _median_ms(lambda: run("cuda"), 3), _median_ms(lambda: run("torch"), 3)
    return {"config": {"layers": cfg.n_layers, "d_hidden": cfg.d_hidden},
            "seeds": shape.batch_nodes, "fanouts": list(shape.fanout),
            "node_slots": int(nodes.size), "E": int(src.size), "masked_edges": int((~mask).sum()),
            "distinct_nodes": int(uniq.size), "d_in": shape.d_feat, "launches": launches,
            "max_err_vs_torch": err, "atol": GNN_ATOL, "forward_ms": ms,
            "forward_ms_torch": plain_ms, "sample_s": sample_s}


def _halo_rank(plan, xs, d_in: int, seed: int) -> dict:
    """One rank of the halo PNA run: its block of the plan through
    ``pna_forward_halo``, the segment-sum launches and the collectives."""
    mesh = partition_mesh()
    if mesh.device.type == "cuda":
        segment_sum_sorted.load()  # the parent built it: same source and flags
    else:  # a rehearsal on the CPU: no card to wait for
        torch.cuda.synchronize = lambda *a, **k: None
    backend = "cuda" if mesh.device.type == "cuda" else "torch"
    model = PNA(ARCHS["pna"].config, d_in, GNN_CLASSES, generator=_init_gen(seed),
                device=mesh.device)
    inputs = rank_inputs(plan, xs, mesh.rank, mesh.device)
    with torch.inference_mode():
        out, launches = _counted(
            lambda: pna_forward_halo(model, mesh, **inputs, backend=backend))
    stats = mesh.stats.snapshot()
    return {"rank": mesh.rank, "out": out.cpu().numpy(), "launches": launches,
            "calls": stats["calls"], "bytes": stats["bytes"],
            "collective_s": stats["seconds"], "backend": backend}


def _gnn_halo(device, seed: int) -> dict:
    """Halo PNA at PNA's full width on HALO_RANKS ranks sharing the card,
    over a scale-16 R-MAT graph split by the BFS-grow partitioner, against
    the dense forward on the card."""
    cfg = ARCHS["pna"].config
    d_in = GRAPH_SHAPES["ogb_products"].d_feat
    t0 = time.perf_counter()
    hpg = bfs_grow_partition(rmat_graph(HALO_SCALE, 8, seed=42), HALO_RANKS, seed=1)
    plan = build_halo_plan(hpg)
    plan_s = time.perf_counter() - t0
    g = hpg.graph
    x = np.random.default_rng(seed + 15).standard_normal((g.n_vertices, d_in)).astype(np.float32)
    t0 = time.perf_counter()
    ranks = run_ranks(_halo_rank, HALO_RANKS, device=device.type,
                      timeout=MESH_LAUNCH_TIMEOUT_S, args=(plan, scatter_nodes(plan, x), d_in,
                                                           seed))
    launch_s = time.perf_counter() - t0
    flat = np.concatenate([r["out"] for r in ranks]).reshape(HALO_RANKS * plan.n_local, -1)
    model = PNA(cfg, d_in, GNN_CLASSES, generator=_init_gen(seed), device=device)
    with torch.inference_mode():
        dense = model(torch.as_tensor(x, device=device), torch.as_tensor(g.src, device=device),
                      torch.as_tensor(g.dst, device=device)).cpu().numpy()
    err = float(np.abs(flat[plan.perm] - dense).max())
    _check(err <= HALO_ATOL, f"halo PNA differs from the dense forward by {err}")
    per_layer = HALO_RANKS * plan.s_max * cfg.d_hidden * 4
    for r in ranks:
        _check(r["calls"] == {"all_to_all": cfg.n_layers},
               f"halo rank {r['rank']}: collectives {r['calls']}, not one all_to_all a layer")
        _check(r["bytes"]["all_to_all"] == cfg.n_layers * per_layer,
               f"halo rank {r['rank']}: {r['bytes']} all_to_all bytes")
        _check(device.type != "cuda" or r["launches"] > 0,
               f"halo rank {r['rank']} launched the segment-sum kernel no time")
    return {"graph": {"scale": HALO_SCALE, "n_vertices": g.n_vertices, "n_edges": g.n_edges,
                      "edge_cut": hpg.edge_cut_fraction},
            "ranks": HALO_RANKS, "backend": ranks.backend, "n_local": plan.n_local,
            "s_max": plan.s_max, "max_abs_err_vs_dense": err, "atol": HALO_ATOL,
            "all_to_all_per_rank": cfg.n_layers,
            "all_to_all_bytes_per_layer": HALO_RANKS * per_layer,
            "all_to_all_bytes_per_layer_expected": "P^2 * s_max * d * 4",
            "launches": sum(r["launches"] for r in ranks),
            "collective_s": max(r["collective_s"] for r in ranks),
            "plan_s": plan_s, "launch_s": launch_s}


def phase_gnn(pg, device, seed: int, scale: int) -> tuple[dict, dict]:
    """The GNN stack on the card (see the module docstring); returns the
    ``gnn`` line and the segment-sum case at PNA's message shape."""
    t0 = time.perf_counter()
    line: dict = {}
    line["pna"], case = _gnn_pna_full(device, seed, scale)
    line["pna_grad"] = _gnn_pna_grads(device, seed)
    line["molecule"] = _gnn_molecules(device, seed)
    line["meshgraphnet"] = _gnn_meshgraphnet(pg, device, seed)
    line["halo_pna"] = _gnn_halo(device, seed)
    launches = {"pna": line["pna"]["launches"], "pna_grad": line["pna_grad"]["launches"],
                "mace": line["molecule"]["mace"]["launches"],
                "dimenet": line["molecule"]["dimenet"]["launches"],
                "meshgraphnet": line["meshgraphnet"]["launches"],
                "halo_pna": line["halo_pna"]["launches"]}
    line.update(launches_by_model=launches, launches=sum(launches.values()),
                peak_device_bytes=line["pna"]["peak_device_bytes"],
                nvidia_smi=_nvidia_smi(), phase_s=time.perf_counter() - t0)
    return line, case


def _random_case(gen, s, n, e, dtype, reduce, device, row_ptr=None, dst=None):
    """Seeded inputs for one reduction: candidates (30% identity), a base
    (30% identity for min) and a sorted dst, random unless given."""
    if dst is None:
        dst = torch.randint(0, n, (e,), generator=gen, device=device).sort().values
        row_ptr = torch.searchsorted(
            dst, torch.arange(n + 1, device=device, dtype=torch.int64)
        ).to(torch.int32)
    ident = _identity_scalar(reduce, dtype).item()

    def values(shape):
        if dtype == torch.int32:
            return torch.randint(0, max(n, 2), shape, generator=gen, device=device,
                                 dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=device) * 10.0

    cand = values((s, e))
    cand[torch.rand((s, e), generator=gen, device=device) < 0.3] = ident
    base = values((s, n))
    if reduce == "min":
        base[torch.rand((s, n), generator=gen, device=device) < 0.3] = ident
    return row_ptr, dst.to(torch.int64), cand, base


def _hold_case(name, variant, reduce, row_ptr, dst, cand, base, reps) -> dict:
    """One kernel call against the plain version; times all three."""
    s, e = cand.shape
    n = base.shape[1]
    out = relax_rowptr(row_ptr, cand, base, reduce=reduce)
    ref = relax_reference(dst, cand, base, reduce)
    torch.cuda.synchronize()
    if reduce == "min":
        ok = torch.equal(out, ref)
    else:
        ok = torch.allclose(out, ref, rtol=1e-5, atol=1e-9)
    err = _max_abs_err(out, ref)
    _check(ok, f"{variant} {name} [S={s}, n={n}, E={e}] disagrees (max abs err {err})")
    idx = dst.expand(s, e)
    lib_reduce = "amin" if reduce == "min" else "sum"
    bound_ms, bound_by = _bound(s, n, e)
    return {
        "case": name, "S": s, "n": n, "E": e, "max_abs_err": err,
        "ms": _median_ms(lambda: relax_rowptr(row_ptr, cand, base, reduce=reduce), reps),
        "ms_back_to_back": _back_to_back_ms(
            lambda: relax_rowptr(row_ptr, cand, base, reduce=reduce), 2 * reps),
        "plain_ms": _median_ms(lambda: relax_reference(dst, cand, base, reduce), reps),
        "library_ms": _median_ms(
            lambda: base.scatter_reduce(1, idx, cand, reduce=lib_reduce, include_self=True),
            reps,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_kernels(pg, seed: int, device) -> dict:
    """Every instantiation the main path runs, at its shapes and at the
    degenerate ones, against the plain version."""
    layout = partitioned_edge_layout(pg)
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for variant, reduce, dtype, prog in MAIN_VARIANTS:
        s_main = BFS_SOURCES if prog == "bfs" else 1
        paths = [("main", s_main, 10)]
        if variant == PATH_VARIANT:
            paths += [("elastic", 1, 5), ("serve", SERVE_BATCH, 5)]
        cases = []
        for path, s, reps in paths:
            for side, lay in (("local", layout.local), ("remote", layout.remote)):
                row_ptr = layout_index_on_device(lay, device, "cuda")
                dst = layout_index_on_device(lay, device, "torch")
                args = _random_case(gen, s, n, lay.n_edges, dtype, reduce, device,
                                    row_ptr=row_ptr, dst=dst)
                name = f"{path}-{side}" + ("" if path == "main" else f"-s{s}")
                cases.append(_hold_case(name, variant, reduce, *args, reps=reps))
                del args
        shapes = (
            ("random-s4", BFS_SOURCES, n, layout.local.n_edges, 10),
            ("e0", BFS_SOURCES, 64, 0, 50),
            ("n_lt_8", BFS_SOURCES, 5, 9, 50),
            ("single_edge", BFS_SOURCES, 40, 1, 50),
        )
        for name, s, nn, e, reps in shapes:
            args = _random_case(gen, s, nn, e, dtype, reduce, device)
            cases.append(_hold_case(name, variant, reduce, *args, reps=reps))
        out[variant] = cases
        torch.cuda.empty_cache()
    return out


def _part_count_bound(r: int, n: int, loaded: int, w: int, p: int) -> tuple[float, str]:
    """Least time on the card for one call: the frontier's bytes, each
    loaded weight and the part ids read once, the sums written once."""
    nbytes = r * n + 4 * n * (loaded + 1) + 4 * w * r * p
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_part_count(pg, seed: int, device) -> dict:
    """The partition counters' kernel at the main path's shapes (see the
    module docstring): each call bit for bit against the plain version."""
    dev = _device_arrays(pg, device)
    n, p, r = pg.graph.n_vertices, pg.n_parts, PART_COUNT_ROWS
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    part64 = dev.part_of.to(torch.int64)
    launches0 = part_count.launches
    cases = []
    for name, weights in (("closure", (dev.ldeg, None)), ("exchange", (dev.rdeg,))):
        for density in PART_COUNT_DENSITIES:
            x = torch.rand((r, n), generator=gen, device=device) < density
            out = part_count(x, weights, dev.part_of, p)
            ref = part_counts_reference(x, weights, dev.part_of, p)
            err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
            _check(err == 0 and torch.equal(out, ref),
                   f"part_count {name} at density {density} differs from the plain version")
            xi = x.to(torch.int32)
            bound_ms, bound_by = _part_count_bound(
                r, n, sum(w is not None for w in weights), len(weights), p)
            cases.append({
                "case": f"{name}-d{density}", "R": r, "n": n, "P": p, "W": len(weights),
                "density": density, "max_abs_err": err,
                "ms": _median_ms(lambda: part_count(x, weights, dev.part_of, p), 20),
                "ms_back_to_back": _back_to_back_ms(
                    lambda: part_count(x, weights, dev.part_of, p), 40),
                "plain_ms": _median_ms(
                    lambda: part_counts_reference(x, weights, dev.part_of, p), 5),
                "library_ms": _median_ms(
                    lambda: torch.zeros((r, p), dtype=torch.int32, device=device).index_add_(
                        1, part64, xi), 10),
                "library": "torch.zeros(R, P).index_add_(1, part_of, x)",
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
            del x, xi
    return {"cases": cases, "launches": part_count.launches - launches0}


def phase_relax_phases(pg, seed: int, device) -> dict:
    """Where relax_rowptr_kernel's time goes: the diagnosis build records
    clock64() at each block's phase boundaries (source 0), at the main
    path's shapes over both layouts; per phase the median cycles over the
    blocks and the share of a block's median life.  Its output is held
    against the plain version like the kernel's."""
    layout = partitioned_edge_layout(pg)
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 4)
    fn = RELAX_PHASE_KERNEL.load().relax_phase_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = ctypes.c_int
    out = {}
    for variant, reduce, dtype, prog in MAIN_VARIANTS[:2]:
        s_main = BFS_SOURCES if prog == "bfs" else 1
        for name, lay in (("main-local", layout.local), ("main-remote", layout.remote)):
            row_ptr = layout_index_on_device(lay, device, "cuda")
            dst = layout_index_on_device(lay, device, "torch")
            row_ptr, dst, cand, base = _random_case(gen, s_main, n, lay.n_edges, dtype, reduce,
                                                    device, row_ptr=row_ptr, dst=dst)
            RELAX_PHASE_KERNEL(row_ptr, cand, base, reduce=reduce)  # warm-up
            got = RELAX_PHASE_KERNEL(row_ptr, cand, base, reduce=reduce)
            torch.cuda.synchronize()
            _check(torch.equal(got, relax_reference(dst, cand, base, reduce)),
                   f"{variant} {name}: the phase-clock build disagrees with the plain version")
            tiles = tile_count(n, lay.n_edges)
            marks = np.zeros((min(tiles, 1 << 16), len(RELAX_PHASES) + 1), dtype=np.int64)
            _check(fn(marks.ctypes.data, tiles) == 0, "reading the relax phase clocks failed")
            spans = np.diff(marks, axis=1)
            life = float(np.median(marks[:, -1] - marks[:, 0]))
            out[f"{variant} {name}"] = {
                "S": s_main, "blocks": int(marks.shape[0]), "median_block_cycles": life,
                "median_cycles": dict(zip(RELAX_PHASES, np.median(spans, axis=0).tolist())),
                "share_of_block": dict(zip(RELAX_PHASES,
                                           (np.median(spans, axis=0) / life).tolist())),
            }
            del cand, base, got
    torch.cuda.empty_cache()
    return out


def phase_relax_entries(pg, seed: int, device) -> dict:
    """The two min-only entries that stood on the TPU's
    ``bfs_relax_kernel_blockmap`` (``bfs_relax_csr``, dst-sorted layout)
    and ``bfs_relax_kernel`` (``bfs_relax``, edges in any order, argsorted
    by destination outside the kernel), at S=1 float32 min over the local
    edges: the kernel alone beside its bound and ``scatter_reduce``, then
    each entry on both backends (held bit-identical) with its time.  It
    runs after the main path, so the edges it caches on the layout never
    reach the main path's peak memory."""
    lay = partitioned_edge_layout(pg).local
    n = pg.graph.n_vertices
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    row_ptr = layout_index_on_device(lay, device, "cuda")
    dst = layout_index_on_device(lay, device, "torch")
    src, dst32, w = layout_edges_on_device(lay, device)
    dist = torch.rand(n, generator=gen, device=device) * 10.0
    dist[torch.rand(n, generator=gen, device=device) < 0.3] = float("inf")
    frontier = torch.rand(n, generator=gen, device=device) < 0.5
    cand = torch.where(frontier[src.long()], dist[src.long()] + w, float("inf"))[None]
    kernel = _hold_case("main-local-s1", "float32-min", "min", row_ptr, dst,
                        cand.contiguous(), dist[None].contiguous(), reps=10)
    perm = torch.randperm(lay.n_edges, generator=gen, device=device)
    edges = (src[perm], dst32[perm], w[perm])
    routes = {
        "bfs_relax_csr": lambda backend: relax_ops.bfs_relax_csr(
            dist, frontier, lay, backend=backend),
        "bfs_relax": lambda backend: relax_ops.bfs_relax(
            dist, frontier, *edges, backend=backend),
    }
    out = {"kernel_s1": kernel}
    for name, fn in routes.items():
        got, ref = fn("cuda"), fn("torch")
        torch.cuda.synchronize()
        _check(torch.equal(got, ref), f"{name}: cuda and torch backends differ")
        before = relax_rowptr.launches
        fn("cuda")
        out[name] = {
            "launches_per_call": relax_rowptr.launches - before,
            "ms": _median_ms(lambda: fn("cuda"), 10),
            "plain_ms": _median_ms(lambda: fn("torch"), 10),
        }
    out["bfs_relax"]["argsort_ms"] = _median_ms(
        lambda: torch.argsort(edges[1].long(), stable=True), 10)
    torch.cuda.empty_cache()
    return out


def phase_oracles(device, seed: int) -> dict:
    """All four programs on a small graph on the card, against the numpy
    oracles (hops and labels exact; SSSP rtol=1e-6 and PageRank rtol=1e-5,
    atol=1e-9 against float64 sums)."""
    g = weighted(rmat_graph(10, 8, seed=seed), seed=seed + 1)
    pg = bfs_grow_partition(g, 8, seed=seed)
    cfg = EngineConfig(device=str(device), backend="cuda")
    sources = [0, 17, 300]
    checked = {}
    for prog in (BfsProgram(), SsspProgram(), WccProgram(), PageRankProgram()):
        dist, _ = bsp.run_program(pg, prog, sources, max_supersteps=128, config=cfg)
        for i, s in enumerate(sources):
            if prog.name == "bfs":
                np.testing.assert_array_equal(dist[i], reference_bfs(pg, s))
            elif prog.name == "sssp":
                np.testing.assert_allclose(dist[i], reference_sssp(pg, s), rtol=1e-6)
            elif prog.name == "wcc":
                np.testing.assert_array_equal(dist[i], reference_wcc(pg))
            else:
                np.testing.assert_allclose(
                    dist[i], reference_pagerank(pg, prog.damping, prog.superstep_budget),
                    rtol=1e-5, atol=1e-9,
                )
        checked[prog.name] = list(dist.shape)
    return {"n_vertices": g.n_vertices, "n_edges": g.n_edges, "checked": checked}


def _main_path_programs(pg, seed: int):
    rng = np.random.default_rng(seed)
    n = pg.graph.n_vertices
    bfs_sources = [0, *rng.choice(np.arange(1, n), BFS_SOURCES - 1, replace=False).tolist()]
    return (
        ("bfs", BfsProgram(), bfs_sources),
        ("wcc", WccProgram(), [0]),
        ("pagerank", PageRankProgram(num_iters=PAGERANK_ITERS), [0]),
    )


def _pagerank_f64(pg, damping: float, iters: int, device) -> np.ndarray:
    """Plain float64 power iteration on the card (``index_add_``), the
    same fixed-budget update as ``PageRankProgram``: the exact reference
    both backends' float32 states are held against."""
    g = pg.graph
    n = g.n_vertices
    src = torch.as_tensor(g.src.astype(np.int64), device=device)
    dst = torch.as_tensor(g.dst.astype(np.int64), device=device)
    inv = 1.0 / torch.as_tensor(np.maximum(g.out_degree, 1), device=device).double()
    contrib_w = inv.index_select(0, src)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    for _ in range(iters):
        acc = torch.zeros_like(rank).index_add_(0, dst, rank.index_select(0, src) * contrib_w)
        rank = (1.0 - damping) / n + damping * acc
    return rank.cpu().numpy()


def _max_rel_err(x: np.ndarray, ref: np.ndarray) -> float:
    x, ref = x.astype(np.float64), ref.astype(np.float64)
    return float((np.abs(x - ref) / np.maximum(np.abs(ref), 1e-30)).max())


def _run(pg, prog, sources, cfg):
    """One traversal through ``bsp.run_program``, timed on the host clock
    around work that ends in the pull to the host."""
    t0 = time.perf_counter()
    dist, traces = bsp.run_program(
        pg, prog, sources, max_supersteps=MAX_SUPERSTEPS, collect_subgraphs=False,
        config=cfg,
    )
    torch.cuda.synchronize()
    return dist, traces, time.perf_counter() - t0


def phase_slice(pg, device, seed: int) -> tuple[dict, dict]:
    cfg = EngineConfig(device=str(device), backend="cuda")
    engine_cfg = cfg.replace(m_max=MAX_SUPERSTEPS, collect_subgraphs=False)
    programs = _main_path_programs(pg, seed)
    engines, setup_s = {}, {}
    for name, prog, _ in programs:  # engine set-up: uploads + row offsets
        t0 = time.perf_counter()
        engines[name] = get_engine(pg, program=prog, config=engine_cfg)
        torch.cuda.synchronize()
        setup_s[name] = time.perf_counter() - t0

    # -- the main path, with every launch count at 0 just before it --------
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, prog, sources in programs:
        syncs0, launches0 = engines[name].host_syncs, relax_rowptr.launches
        counts0 = engines[name].part_count_launches
        dist, traces, secs = _run(pg, prog, sources, cfg)
        runs[name] = {
            "dist": dist, "traces": traces, "seconds": secs,
            "host_syncs": engines[name].host_syncs - syncs0,
            "launches": relax_rowptr.launches - launches0,
            "part_count_launches": engines[name].part_count_launches - counts0,
        }
    launches = relax_rowptr.launches
    variant_launches = dict(relax_rowptr.variant_launches)
    count_launches = part_count.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    # -- end of the main path ----------------------------------------------
    _check(launches > 0, "the main path launched the relax kernel no time")
    _check_part_count_launches(count_launches, sum(r["part_count_launches"] for r in runs.values()),
                               device, "the main path")
    for variant, _, _, prog in MAIN_VARIANTS:
        _check(variant_launches[variant] > 0, f"{variant} ({prog}) was never launched")

    report = {}
    plain_cfg = cfg.replace(backend="torch")
    for name, prog, sources in programs:
        run = runs[name]
        _, _, warm_s = _run(pg, prog, sources, cfg)
        get_engine(pg, program=prog, config=engine_cfg.replace(backend="torch"))
        plain_dist, plain_traces, plain_s = _run(pg, prog, sources, plain_cfg)
        if name == "pagerank":
            exact = _pagerank_f64(pg, prog.damping, prog.superstep_budget, device)
            pagerank_err = {
                "cuda": _max_rel_err(run["dist"][0], exact),
                "torch": _max_rel_err(plain_dist[0], exact),
                "cuda_vs_torch": _max_rel_err(run["dist"][0], plain_dist[0]),
            }
            np.testing.assert_allclose(
                run["dist"][0], exact, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL
            )
            np.testing.assert_allclose(
                run["dist"], plain_dist, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL
            )
        else:
            np.testing.assert_array_equal(run["dist"], plain_dist)
        for t_k, t_p in zip(run["traces"], plain_traces):
            for field in ("active", "edges_examined", "verts_processed", "msgs_sent",
                          "inner_iters"):
                np.testing.assert_array_equal(getattr(t_k, field), getattr(t_p, field))
        report[name] = {
            "S": len(sources),
            "supersteps": [t.n_supersteps for t in run["traces"]],
            "inner_iters": [int(t.inner_iters.sum()) for t in run["traces"]],
            "kernel_launches": run["launches"],
            "part_count_launches": run["part_count_launches"],
            "host_syncs": run["host_syncs"],
            "engine_setup_s": setup_s[name],
            "cuda_s": run["seconds"],
            "cuda_warm_s": warm_s,
            "torch_backend_s": plain_s,
        }

    # -- the output is right by the repo's own means ------------------------
    n = pg.graph.n_vertices
    bfs = runs["bfs"]["dist"]
    row_ptr, col, _ = pg.graph.csr
    hops = _bfs_hops(row_ptr, col, n, 0)
    np.testing.assert_array_equal(bfs[0], hops.astype(np.float32))
    _check(bfs.shape == (BFS_SOURCES, n) and np.isfinite(bfs).all(),
           "BFS left vertices unreached on a connected graph")
    wcc = runs["wcc"]["dist"]
    _check(wcc.dtype == np.int32 and (wcc == 0).all(),
           "WCC labels of the connected graph are not all 0")
    pr = runs["pagerank"]["dist"]
    _check(pr.dtype == np.float32 and np.isfinite(pr).all() and (pr > 0).all(),
           "PageRank is not finite and positive")
    _check(abs(float(pr.sum(dtype=np.float64)) - 1.0) < 1e-3,
           f"PageRank mass {float(pr.sum(dtype=np.float64))} is not 1")

    summary = {
        "programs": report,
        "kernel_launches": launches,
        "variant_launches": variant_launches,
        "part_count_launches": count_launches,
        "peak_device_bytes": peak_bytes,
        "bfs_source0_matches_host_bfs": True,
        "pagerank_max_rel_err": pagerank_err,
    }
    return summary, runs


def phase_pipeline(pg, trace) -> tuple[dict, TimeFunction]:
    """The trace billed per strategy, and the metagraph's prediction (in
    the engine's unscaled units), which the elastic phase plans from."""
    tf = TimeFunction.from_trace(trace).scaled_to_tmin(LIVJ_T_MIN_S)
    model = BillingModel(delta=BILLING_DELTA_S)
    table = []
    for name, strategy in STRATEGIES.items():
        r = evaluate(strategy(tf), model)
        _check(np.isfinite(r.makespan) and r.makespan >= tf.t_min() * (1 - 1e-9),
               f"{name}: makespan {r.makespan} below T_Min {tf.t_min()}")
        _check(r.cost_quanta >= 1, f"{name}: no quanta billed")
        table.append({
            "strategy": name, "makespan_s": r.makespan,
            "makespan_over_tmin": r.makespan_over_tmin, "cost_quanta": r.cost_quanta,
            "core_secs": r.core_secs, "peak_vms": r.peak_vms,
        })
    t0 = time.perf_counter()
    n_subgraphs = pg.n_subgraphs
    t1 = time.perf_counter()
    pred_tf, sched = predict_time_function(pg, 0)
    t2 = time.perf_counter()
    _check(sched.n_supersteps > 0 and np.isfinite(pred_tf.tau).all(),
           "the metagraph predicted no supersteps")
    return {
        "t_min_s": tf.t_min(), "supersteps": tf.n_supersteps,
        "cost_table": table,
        "n_subgraphs": n_subgraphs, "subgraphs_s": t1 - t0,
        "predicted_supersteps": sched.n_supersteps, "predict_s": t2 - t1,
    }, pred_tf


def _zero_launch_counts() -> None:
    relax_rowptr.launches = 0
    relax_rowptr.variant_launches = dict.fromkeys(VARIANTS, 0)
    part_count.launches = 0


def _check_part_count_launches(kernel: int, engines: int, device, what: str) -> None:
    """The partition counters' kernel launches on a path (``kernel``, its
    own count) against those its engines counted (``engines``, the sum of
    their ``part_count_launches``): equal, and above 0 on the card."""
    _check(kernel == engines, f"{what}: {kernel} partition-counter launches, the engines "
           f"counted {engines}")
    _check(device.type != "cuda" or kernel > 0,
           f"{what} launched the partition counters' kernel no time")


def _report_fields(rep) -> dict:
    """An ``ExecutionReport`` as plain comparable values, wall time dropped."""
    out = {k: v for k, v in vars(rep).items() if k != "wall_seconds"}
    out["actual_tau"] = rep.actual_tau.tau
    out["cost"] = dict(vars(rep.cost))
    return out


def _check_reports_equal(a, b, what: str) -> None:
    fa, fb = _report_fields(a), _report_fields(b)
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            same = fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        else:
            same = fa[k] == fb[k]
        _check(same, f"{what}: ExecutionReport.{k} differs")


def _execute(pg, cfg, tau, plan, **run_kw):
    """One ``ElasticBSPExecutor.run`` of BFS from vertex 0, timed on the host
    clock; also the engine's own host reads (loop conditions + pulls, over
    every engine the run used), the relax kernel's launches in it and the
    partition counters' kernel launches, by the kernel and by the engines."""
    ex = ElasticBSPExecutor(pg, program=BfsProgram(), tau_scale=tau, config=cfg)
    first, syncs0, launches0 = ex.engine, ex.engine.host_syncs, relax_rowptr.launches
    counts0, engine_counts0 = part_count.launches, first.part_count_launches
    t0 = time.perf_counter()
    rep = ex.run(0, plan, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_syncs = first.host_syncs - syncs0
    engine_counts = first.part_count_launches - engine_counts0
    if ex.engine is not first:  # a mutation built the merged graph's engine
        engine_syncs += ex.engine.host_syncs
        engine_counts += ex.engine.part_count_launches
    return ex, rep, {
        "cost_quanta": rep.cost.cost_quanta,
        "makespan_over_tmin": rep.cost.makespan_over_tmin,
        "migrations": rep.n_migrations, "migration_bytes": rep.migration_bytes,
        "replans": rep.replans, "windows": rep.host_syncs - 1,
        "supersteps": rep.n_supersteps,
        "host_syncs_executor": rep.host_syncs, "host_syncs_engine": engine_syncs,
        "relax_launches": relax_rowptr.launches - launches0,
        "part_count_launches": part_count.launches - counts0,
        "part_count_launches_engine": engine_counts,
        "wall_s": wall,
    }


def _insert_buffer(n: int, seed: int) -> EdgeDeltaBuffer:
    rng = np.random.default_rng(seed)
    buf = EdgeDeltaBuffer(capacity=MUTATION_INSERTS)
    buf.insert_many(rng.integers(0, n, MUTATION_INSERTS), rng.integers(0, n, MUTATION_INSERTS))
    return buf


def _mutation_run(pg, cfg, tau, plan, seed: int, repartition, base_row) -> dict:
    """One executor run with the seeded inserts merged at superstep 4, held
    against ``bsp.run_program`` on the mutated graph and against the host
    BFS over the mutated graph's CSR; ``base_row`` is BFS from vertex 0 on
    ``pg`` before the merge."""
    torch.cuda.reset_peak_memory_stats()
    ex, rep, line = _execute(pg, cfg, tau, plan, mutations=[(MUTATION_STEP, _insert_buffer(
        pg.graph.n_vertices, seed))], repartition=repartition)
    line["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    _check(rep.mutations_applied == 1, "the delta buffer was not merged")
    _check(not repartition or rep.repartition_moves > 0, "the repartitioner moved no vertex")
    _check(line["relax_launches"] > 0, "the mutation run launched the relax kernel no time")
    fresh, _ = bsp.run_program(ex.pg, BfsProgram(), [0], max_supersteps=MAX_SUPERSTEPS,
                               config=EngineConfig(device=cfg.device, backend="cuda"))
    _check(np.array_equal(rep.dist, fresh[0]),
           "the mutated run's state differs from a fresh run on the mutated graph")
    g = ex.pg.graph
    _check(g.n_edges == pg.graph.n_edges + MUTATION_INSERTS,
           f"the merged graph holds {g.n_edges} edges, not {pg.graph.n_edges} + "
           f"{MUTATION_INSERTS}")
    row_ptr, col, _ = g.csr
    _check(np.array_equal(rep.dist, _bfs_hops(row_ptr, col, g.n_vertices, 0).astype(np.float32)),
           "the mutated run's state differs from the host BFS on the mutated graph")
    line.update(mutations_applied=rep.mutations_applied,
                repartition_moves=rep.repartition_moves,
                edges_after=ex.pg.graph.n_edges,
                vertices_changed_by_inserts=int((rep.dist != base_row).sum()))
    return line


def phase_elastic(pg, bfs_row, trace, pred_tf, device, seed: int) -> dict:
    """The plan executed window by window (see the module docstring)."""
    tau = LIVJ_T_MIN_S / TimeFunction.from_trace(trace).t_min()
    sketch = TimeFunction(pred_tf.tau * tau)  # the prediction in the trace's seconds
    cfg = EngineConfig(device=str(device), backend="cuda", window=ELASTIC_WINDOW)
    # name -> (plan, strategy); the last plan covers only the prediction's
    # first supersteps, so its run outruns the plan and re-plans
    plans = {name: (strategy(sketch), strategy) for name, strategy in STRATEGIES.items()}
    cut_plan = f"ffd-plan-cut-{REPLAN_PLAN_STEPS}"
    plans[cut_plan] = (STRATEGIES["ffd"](TimeFunction(sketch.tau[:REPLAN_PLAN_STEPS])),
                       STRATEGIES["ffd"])

    def run(name, cfg_):
        plan, strategy = plans[name]
        return _execute(pg, cfg_, tau, plan, strategy_fn=strategy, replan=True, sketch=sketch)

    # -- the path, with every launch count at 0 just before it -------------
    _zero_launch_counts()
    main = {name: run(name, cfg) for name in plans}
    launches, variant_launches = relax_rowptr.launches, dict(relax_rowptr.variant_launches)
    count_launches = part_count.launches
    # -- end of the path -----------------------------------------------------
    _check(launches > 0, "the elastic path launched the relax kernel no time")
    _check_part_count_launches(
        count_launches, sum(line["part_count_launches_engine"] for _, _, line in main.values()),
        device, "the elastic path")
    _check(main[cut_plan][1].replans > 0, f"{cut_plan}: the run outran its plan but never "
           "re-planned")
    table = {}
    for name, (_, rep, line) in main.items():
        _check(line["relax_launches"] > 0, f"{name}: the run launched the relax kernel no time")
        _check(np.array_equal(rep.dist, bfs_row), f"{name}: state differs from the slice's BFS")
        _, plain, plain_line = run(name, cfg.replace(backend="torch"))
        _check_reports_equal(rep, plain, f"{name} cuda vs torch backend")
        _, step1, step1_line = run(name, cfg.replace(window=1))
        _check(np.array_equal(step1.dist, rep.dist)
               and np.array_equal(step1.actual_tau.tau, rep.actual_tau.tau),
               f"{name}: one-superstep windows changed the state or tau")
        _check(step1.host_syncs == step1.n_supersteps + 1,
               f"{name}: {step1.host_syncs} bulk pulls for {step1.n_supersteps} windows")
        table[name] = {**line, "torch_backend_wall_s": plain_line["wall_s"],
                       "window1": {k: step1_line[k] for k in (
                           "host_syncs_executor", "host_syncs_engine", "wall_s")}}

    mutation = _mutation_run(pg, cfg.replace(window=MUTATION_WINDOW), tau, plans["ffd"][0], seed,
                             repartition=None, base_row=bfs_row)
    torch.cuda.empty_cache()

    # -- repartition= : cut when one pass over the full graph is too slow --
    t0 = time.perf_counter()
    partition_penalty(pg.graph, pg.part_of_vertex)
    penalty_s = time.perf_counter() - t0
    candidates = 4 * RepartitionConfig().max_moves
    cut = penalty_s * candidates > REPARTITION_MAX_S
    rpg = build_graph(REPARTITION_CUT_SCALE, LIVJ_PARTS)[0] if cut else pg
    rrow, rtrace = bsp.run_sssp(rpg, 0, max_supersteps=MAX_SUPERSTEPS, collect_subgraphs=False,
                                config=EngineConfig(device=str(device), backend="cuda"))
    rtf = TimeFunction.from_trace(rtrace)
    t0 = time.perf_counter()
    rcfg = RepartitionConfig(max_candidates=REPARTITION_CANDIDATES)
    repartitioned = _mutation_run(
        rpg, cfg.replace(window=MUTATION_WINDOW), LIVJ_T_MIN_S / rtf.t_min(),
        STRATEGIES["ffd"](rtf.scaled_to_tmin(LIVJ_T_MIN_S)), seed, repartition=rcfg,
        base_row=rrow)
    repartitioned.update(cut=cut, scale=int(np.log2(rpg.graph.n_vertices)),
                         full_graph_penalty_s=penalty_s, default_candidates=candidates,
                         projected_full_pass_s=penalty_s * candidates,
                         candidates=REPARTITION_CANDIDATES, run_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return {
        "program": "bfs", "source": 0, "window": ELASTIC_WINDOW, "tau_scale": tau,
        "t_min_s": LIVJ_T_MIN_S, "strategies": table, "plan_cut_run": cut_plan,
        "kernel_launches": launches, "variant_launches": variant_launches,
        "part_count_launches": count_launches,
        "mutation": {"window": MUTATION_WINDOW, "at_superstep": MUTATION_STEP,
                     "inserts": MUTATION_INSERTS, **mutation},
        "repartition": repartitioned,
    }


@contextlib.contextmanager
def _retired_rows(rows: dict):
    """Keep, per query id, the state row its batch row held when it retired
    (a copy on the card).  A row retires when its query completes, or before
    a requeue; the query's last retirement is its completion, so after the
    run ``rows[q.qid]`` is the answer of every completed query ``q``."""
    retire = MicroBatcher.retire

    def keep(self, row):
        rec = retire(self, row)
        rows[rec.qid] = self.state.dist[row].clone()
        return rec

    MicroBatcher.retire = keep
    try:
        yield rows
    finally:
        MicroBatcher.retire = retire


def _serve(pg, trace, cfg: ServiceConfig, ecfg: EngineConfig, rows: dict | None = None):
    """One ``TraversalService.run``: the report and its line, with the lane
    engine's host reads and the relax kernel's launches in it; ``rows``
    also collects the completed queries' state rows (``_retired_rows``)."""
    engine = get_engine(pg, program=SsspProgram(), config=ecfg)
    syncs0, launches0 = engine.host_syncs, relax_rowptr.launches
    counts0 = engine.part_count_launches
    splits0 = relax_rowptr.partition_launches
    t0 = time.perf_counter()
    with _retired_rows(rows) if rows is not None else contextlib.nullcontext():
        rep = TraversalService(pg, config=cfg, engine_config=ecfg).run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(rep.completed + rep.rejected + rep.dropped == rep.offered,
           f"{rep.offered} queries offered, {rep.completed} + {rep.rejected} + "
           f"{rep.dropped} accounted for")
    return rep, {
        "offered": rep.offered, "completed": rep.completed,
        "queries_per_s": rep.queries_per_sec,
        "sojourn_p50_s": rep.sojourn_p50, "sojourn_p99_s": rep.sojourn_p99,
        "occupancy": rep.occupancy, "capacity_mean": rep.capacity_mean,
        "capacity_peak": rep.capacity_peak, "cost_quanta": rep.cost.cost_quanta,
        "cost_per_1k_queries": rep.cost_per_1k_queries, "windows": rep.windows,
        "supersteps": rep.supersteps, "wall_s": wall,
        "wall_s_per_window": wall / max(rep.windows, 1),
        "host_syncs_engine": engine.host_syncs - syncs0,
        "relax_launches": relax_rowptr.launches - launches0,
        "partition_launches": relax_rowptr.partition_launches - splits0,
        "part_count_launches_engine": engine.part_count_launches - counts0,
    }


def phase_serve(pg, trace, device, seed: int) -> dict:
    """A stream of BFS queries served under elastic capacity (see the
    module docstring)."""
    tau = LIVJ_T_MIN_S / TimeFunction.from_trace(trace).t_min()
    cfg = ServiceConfig(s_batch=SERVE_BATCH, window=ELASTIC_WINDOW, tau_scale=tau)
    static_cfg = dataclasses.replace(cfg, static_vms=cfg.max_vms)
    ecfg = EngineConfig(device=str(device), backend="cuda")
    n = pg.graph.n_vertices

    # -- the path, with every launch count at 0 just before it -------------
    _zero_launch_counts()
    _, burst = _serve(pg, poisson_trace(SERVE_QUERIES, 1e9, n, seed=seed), static_cfg, ecfg)
    mu = burst["queries_per_s"]
    frac = SERVE_RATE_FRACTIONS[-1]  # the rate held against the torch backend
    rates, reports, rows = {}, {}, {}
    for f in SERVE_RATE_FRACTIONS:
        trace_f = poisson_trace(SERVE_QUERIES, f * mu, n, seed=seed)
        reports[f], elastic = _serve(pg, trace_f, cfg, ecfg, rows if f == frac else None)
        _, static = _serve(pg, trace_f, static_cfg, ecfg)
        rates[f"{f}mu"] = {"rate_qps": f * mu, "elastic": elastic, "static": static}
    launches, variant_launches = relax_rowptr.launches, dict(relax_rowptr.variant_launches)
    count_launches = part_count.launches
    # -- end of the path -----------------------------------------------------
    _check(launches > 0, "the serving path launched the relax kernel no time")
    _check_part_count_launches(
        count_launches, burst["part_count_launches_engine"] + sum(
            row[mode]["part_count_launches_engine"] for row in rates.values()
            for mode in ("elastic", "static")), device, "the serving path")
    for key, row in rates.items():
        for mode in ("elastic", "static"):
            _check(row[mode]["relax_launches"] > 0, f"{key} {mode}: no relax launch")
            _check(row[mode]["partition_launches"] == 0,
                   f"{key} {mode}: the relax kernel split a layout again")
        _check(row["elastic"]["cost_quanta"] <= row["static"]["cost_quanta"],
               f"{key}: elastic billed {row['elastic']['cost_quanta']} quanta, static "
               f"{row['static']['cost_quanta']}")
    plain_rows = {}
    plain, plain_line = _serve(pg, poisson_trace(SERVE_QUERIES, frac * mu, n, seed=seed), cfg,
                               ecfg.replace(backend="torch"), plain_rows)
    _check(plain.asdict() == reports[frac].asdict(),
           f"{frac}mu: the cuda and torch backends' ServiceReports differ")
    # the answers: every completed query's state row on both backends, and
    # the first few against the host BFS (SSSP on unit weights = hops)
    done = reports[frac].queries
    _check(len(done) > 0, f"{frac}mu: no query completed")
    for q in done:
        _check(torch.equal(rows[q.qid], plain_rows[q.qid]),
               f"{frac}mu: query {q.qid} (source {q.source}) answered differently on the "
               "cuda and torch backends")
    row_ptr, col, _ = pg.graph.csr
    for q in done[:SERVE_HOST_CHECKS]:
        hops = _bfs_hops(row_ptr, col, n, q.source).astype(np.float32)
        _check(np.array_equal(rows[q.qid].cpu().numpy(), hops),
               f"{frac}mu: query {q.qid} (source {q.source}) differs from the host BFS")
    del rows, plain_rows
    return {
        "program": "sssp", "queries": SERVE_QUERIES, "s_batch": SERVE_BATCH,
        "window": ELASTIC_WINDOW, "tau_scale": tau, "mu_qps": mu, "burst_static": burst,
        "rates": rates, "torch_backend_identical_at": f"{frac}mu",
        "answers_held": {"against_torch_backend": len(done),
                         "against_host_bfs": len(done[:SERVE_HOST_CHECKS])},
        "torch_backend_wall_s": plain_line["wall_s"],
        "kernel_launches": launches, "variant_launches": variant_launches,
        "part_count_launches": count_launches,
    }


def _device_rows(prof) -> list:
    """A profile's device activity (kernels, copies) by name: ``(name, ms,
    count)``, the most device time first."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            slot = by_name.setdefault(ev.name, [0.0, 0])
            slot[0] += ev.time_range.elapsed_us() / 1e3
            slot[1] += 1
    return sorted(((k, ms, c) for k, (ms, c) in by_name.items()), key=lambda r: -r[1])


def phase_profile(pg, device, seed: int) -> dict:
    """One warm BFS traversal under ``torch.profiler``: the card's busy
    share of the traversal's wall time, the relax kernel's share of the
    busy time, and the kernels that take the most device time.  The
    profiler's own overhead lengthens the wall time, so the busy share is
    a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    _, prog, sources = _main_path_programs(pg, seed)[0]
    cfg = EngineConfig(device=str(device), backend="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, secs = _run(pg, prog, sources, cfg)
    rows = _device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    # the relax reduction is three kernels: partition, reduction, fix-up
    relax_parts = {
        part: sum(r[1] for r in rows if part in r[0]) for part in RELAX_KERNEL_SYMBOLS
    }
    relax_ms = sum(relax_parts.values())
    _check(relax_parts["relax_rowptr_kernel"] > 0,
           "the profile found no relax_rowptr_kernel in the BFS traversal")
    return {
        "program": prog.name, "S": len(sources), "wall_ms": secs * 1e3,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / (secs * 1e3),
        "relax_kernel_ms": relax_ms,
        "relax_kernel_ms_by_part": relax_parts,
        "top": [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]],
    }


# -- the mesh phase: the multi-GPU engine on ranks that share the card ----------


class _HostMemory:
    """The machine's host memory in use over a block, at its peak per stage
    (sampled from ``/proc/meminfo`` every 0.2 s by a thread), and this
    process's resident size at the report."""

    def __enter__(self):
        import threading

        self.total = self._meminfo()["MemTotal"]
        self.least_available = self._meminfo()["MemAvailable"]
        self.marks: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @staticmethod
    def _meminfo() -> dict:
        with open("/proc/meminfo") as f:
            return {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}

    def _sample(self):
        while not self._stop.wait(0.2):
            self.least_available = min(self.least_available, self._meminfo()["MemAvailable"])

    def mark(self, stage: str) -> None:
        """Record the peak in use up to the end of ``stage``, and reset it."""
        self.marks.append((stage, self.total - self.least_available))
        self.least_available = self._meminfo()["MemAvailable"]

    def report(self) -> dict:
        return {
            "total_bytes": self.total,
            "peak_in_use_bytes": max([self.total - self.least_available]
                                     + [b for _, b in self.marks]),
            "peak_in_use_by_stage": dict(self.marks),
            "parent_rss_bytes": _rss(),
        }


def _gloo_cuda_probe() -> dict:
    """Whether this PyTorch's gloo takes CUDA tensors in each collective the
    engine runs (even and uneven all-to-all, all-reduce, all-gather), with
    the results checked.  The engine hands gloo its CUDA tensors as they lie
    (``PartitionMesh.transport``); a refusal here fails the mesh phase."""
    import torch.distributed as dist

    world, me = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * world, dtype=torch.float32, device="cuda") + 100 * me
    uneven_send = [j + 1 for j in range(world)]  # j + 1 rows to rank j
    uneven_recv = [me + 1] * world
    v = torch.full((sum(uneven_send),), float(me), device="cuda")

    def a2a():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.tensor([100.0 * j + 2 * me + k for j in range(world) for k in (0, 1)])
        return torch.equal(out.cpu(), want)

    def a2a_v():
        out = torch.empty(sum(uneven_recv), device="cuda")
        dist.all_to_all_single(out, v, uneven_recv, uneven_send)
        want = torch.tensor([float(j) for j in range(world) for _ in range(me + 1)])
        return torch.equal(out.cpu(), want)

    def reduce():
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return torch.equal(y.cpu(), torch.arange(2 * world, dtype=torch.float32)
                           + 100 * (world - 1))

    def gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return all(torch.equal(o.cpu(), x.cpu() - 100 * me + 100 * j) for j, o in enumerate(out))

    out = {}
    for name, fn in (("all_to_all_single", a2a), ("all_to_all_single_uneven", a2a_v),
                     ("all_reduce", reduce), ("all_gather", gather)):
        try:
            out[name] = "ok" if fn() else "wrong result"
        except (RuntimeError, ValueError, TypeError) as exc:  # the probe's answer
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return out


def _rss() -> int:
    """This process's resident host memory now, in bytes (``/proc/self/
    statm``; a rank samples it after each step, since ``ru_maxrss`` carries
    the parent's peak across the fork)."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _rank_config(mesh, **kw) -> EngineConfig:
    """A rank's engine config: the CUDA kernel on the rank's card (the
    plain version only where the ranks run on the CPU, as in a rehearsal
    without a card)."""
    kind = mesh.device.type
    return EngineConfig(device=kind, backend="cuda" if kind == "cuda" else "torch", mesh=mesh,
                        **kw)


def _mesh_run(pg, mesh, prog, sources, mirror_degree) -> dict:
    """One traversal on this rank through ``TraversalEngine.run``, with the
    kernel's launch counts at 0 just before it and read just after."""
    import torch.distributed as dist

    cfg = _rank_config(mesh, m_max=MAX_SUPERSTEPS, mirror_degree=mirror_degree)
    t0 = time.perf_counter()
    eng = get_engine(pg, program=prog, config=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_rss = _rss()
    mprog = eng._mesh_prog
    ml = mprog.layout
    edges = {kind: ml.plane(kind)[2] for kind in ("local", "wire")}
    edges["mirror"] = ml.plane("mirror")[2] if ml.m_pad else 0
    dist.barrier()
    # -- the path, with every launch count at 0 just before it -------------
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats0, reads0, pulls0 = mesh.stats.snapshot(), mprog.host_reads, eng.bulk_pulls
    counts0 = eng.part_count_launches
    t0 = time.perf_counter()
    res = eng.run(sources)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = relax_rowptr.launches, dict(relax_rowptr.variant_launches)
    count_launches = part_count.launches
    # -- end of the path -----------------------------------------------------
    stats1 = mesh.stats.snapshot()
    run = {
        "wall_s": wall, "setup_s": setup_s,
        "host_reads": mprog.host_reads - reads0, "bulk_pulls": eng.bulk_pulls - pulls0,
        "launches": launches, "variant_launches": variants, "plane_edges": edges,
        "part_count_launches": count_launches,
        "part_count_launches_engine": eng.part_count_launches - counts0,
        "collective_s": stats1["seconds"] - stats0["seconds"],
        "collective_calls": {k: v - stats0["calls"].get(k, 0) for k, v in stats1["calls"].items()},
        "collective_bytes": {k: v - stats0["bytes"].get(k, 0) for k, v in stats1["bytes"].items()},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "host_rss_bytes": (setup_rss, _rss()),
        "signature": mprog.signature, "record": mprog.last_window_collectives,
        "pads": {k: int(getattr(ml, k)) for k in ("n_pad", "e_local_pad", "e_remote_pad", "w_pad",
                                                   "e_mirror_pad", "m_pad")},
    }
    if mesh.rank == 0:
        run["result"] = {f: np.asarray(getattr(res, f)) for f in res._fields if f != "sg_active"}
    pg.__dict__.pop("_traversal_engines", None)
    del eng, mprog, res
    torch.cuda.empty_cache()
    return run


def _mesh_swap_run(pg, mesh, sources) -> dict:
    """BFS in two windows on this rank, ranks 0 and 1 trading their
    partitions in between: a pad-stable re-layout, rebuilt from the active
    block (reusing what the swap leaves alone), with the state moved
    between ranks.  Returns the swap's build record and, on rank 0, the
    gathered state."""
    cfg = _rank_config(mesh, m_max=MAX_SUPERSTEPS)
    eng = get_engine(pg, program=BfsProgram(), config=cfg)
    dmap = eng.device_of_part
    swapped = np.where(dmap == 0, 1, np.where(dmap == 1, 0, dmap)).astype(np.int32)
    t0 = time.perf_counter()
    first = eng.run_window(eng.init_state(sources), MESH_SWAP_AFTER)
    rest = eng.run_window(first.state, MAX_SUPERSTEPS, device_of_part=swapped)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "build": eng._mesh_prog.relayouts[-1],
           "done": bool(np.asarray(rest.done).all()),
           "map_after": eng.device_of_part.tolist()}
    dist = eng.gather_global(rest.state.dist)
    if mesh.rank == 0:
        out["dist"] = dist
    pg.__dict__.pop("_traversal_engines", None)
    del eng, first, rest
    torch.cuda.empty_cache()
    return out


def _mesh_rank(shared: str, stages: list, probe: bool, swap_sources: list | None,
               planes: tuple | None, executor: dict | None) -> dict:
    """One rank of the mesh phase, in its own process: map the graph the
    parent shared, build this rank's own block of each layout, run the
    traversals (and, at D = 8, the relax kernel at the hub rank's planes, a
    swap re-layout and the executor, on the graph ``executor["graph"]``
    names where the parent shared a cut one)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    pg = load_shared_graph(shared)
    mesh = partition_mesh()
    if mesh.device.type == "cuda":
        relax_rowptr.load()  # the parent built it: same source and flags
    else:  # a rehearsal on the CPU: no card to wait for or to measure
        for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    out = {"rank": mesh.rank, "mesh": mesh.describe(), "load_s": time.perf_counter() - t0,
           "load_rss_bytes": _rss(), "layouts": {}, "runs": {}}
    if probe and mesh.device.type == "cuda":
        out["gloo_cuda_probe"] = _gloo_cuda_probe()
        if any(v != "ok" for v in out["gloo_cuda_probe"].values()):
            raise RuntimeError(f"gloo on CUDA tensors: {out['gloo_cuda_probe']}")
    dmap = contiguous_device_map(pg.n_parts, mesh.world_size)
    for mirror_degree, jobs in stages:
        t0 = time.perf_counter()
        ml = mesh_rank_layout(pg, dmap, mesh.world_size, mesh.rank, mirror_degree=mirror_degree,
                              mesh=mesh)
        out["layouts"][str(mirror_degree)] = {
            "seconds": time.perf_counter() - t0, "rss_bytes": _rss(),
            "host_bytes": sum(v.nbytes for v in vars(ml).values() if isinstance(v, np.ndarray)),
        }
        if planes is not None and mirror_degree is None:
            # the kernel at the hub rank's planes, timed while the others wait
            # (ranks on the CPU, a rehearsal, have no kernel to time)
            dist.barrier()
            if mesh.rank == planes[0] and mesh.device.type == "cuda":
                out["kernel_planes"] = _mesh_plane_cases(ml, mesh.device, planes[1])
            dist.barrier()
        del ml
        for name, prog, sources in jobs:
            out["runs"][name] = _mesh_run(pg, mesh, prog, sources, mirror_degree)
    if swap_sources is not None:
        out["swap"] = _mesh_swap_run(pg, mesh, swap_sources)
    if executor is not None:
        xpg = load_shared_graph(executor["graph"]) if executor.get("graph") else pg
        cfg = _rank_config(mesh, window=1, relayout=True)
        _zero_launch_counts()
        stats0 = mesh.stats.snapshot()
        ex, rep, line = _execute(xpg, cfg, executor["tau"], executor["plan"],
                                 strategy_fn=STRATEGIES["ffd"], replan=True,
                                 sketch=executor["sketch"])
        line["collective_s"] = mesh.stats.snapshot()["seconds"] - stats0["seconds"]
        line["relayout_builds"] = ex.engine._mesh_prog.relayouts
        out["executor"] = {"line": line, "report": _report_fields(rep),
                           "host_rss_bytes": _rss(),
                           "variant_launches": dict(relax_rowptr.variant_launches),
                           "part_count_launches": part_count.launches}
    return out


def _mesh_plane_cases(ml, device, seed: int) -> list:
    """The relax kernel at one rank's D = 8 shapes (float32 min, S = 4: the
    BFS batch), its local plane and its wire plane as the engine hands them
    over -- padding included -- against the plain version."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 8)
    cases = []
    for kind in ("local", "wire"):
        rows, n_seg, n_valid = ml.plane(kind)
        row_ptr = torch.as_tensor(ml.row_ptr(kind), device=device)
        dst = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
        args = _random_case(gen, BFS_SOURCES, n_seg, int(rows.shape[0]), torch.float32, "min",
                            device, row_ptr=row_ptr, dst=dst)
        case = _hold_case(f"mesh-D8-rank{ml.rank}-{kind}", "float32-min", "min", *args, reps=10)
        case["valid_edges"] = n_valid
        cases.append(case)
        del args
    torch.cuda.empty_cache()
    return cases


def _mesh_executor_plan(pg, trace, pred_tf, device) -> dict:
    """The FFD plan the elastic phase runs (planned from ``trace`` and the
    prediction), how many layouts ``relayout=True`` visits under it on 8
    ranks, and the dense executor's report under it (one superstep a
    window)."""
    tau = LIVJ_T_MIN_S / TimeFunction.from_trace(trace).t_min()
    sketch = TimeFunction(pred_tf.tau * tau)
    plan = STRATEGIES["ffd"](sketch)
    # one map per planned row that moves a placed partition to another rank
    cur, maps = contiguous_device_map(pg.n_parts, MESH_SIZES[0]), 0
    for row in plan.vm_of:
        target = cur.copy()
        placed = row >= 0
        target[placed] = device_of_vm(row[placed], MESH_SIZES[0])
        if not np.array_equal(target, cur):
            maps, cur = maps + 1, target
    cfg = EngineConfig(device=str(device), backend="cuda", window=1)
    _, dense, dense_line = _execute(pg, cfg, tau, plan, strategy_fn=STRATEGIES["ffd"],
                                    replan=True, sketch=sketch)
    return {"args": {"tau": tau, "plan": plan, "sketch": sketch, "maps": maps},
            "dense": dense, "dense_wall_s": dense_line["wall_s"]}


def _check_mesh_runs(results, dense: dict, d_n: int) -> dict:
    """The D-rank traversals against the dense engine on the card; returns
    their summary for the ``mesh`` line."""
    out = {}
    rank0 = results[0]["runs"]
    for name, runs in ((n, [r["runs"][n] for r in results]) for n in rank0):
        base = name.removesuffix("-mirror")
        mesh_res, ref = rank0[name]["result"], dense[base]
        for f in ("dist", "frontier", "n_supersteps", "edges_examined", "verts_processed",
                  "msgs_sent", "inner_iters"):
            a, b = mesh_res[f], np.asarray(getattr(ref, f))
            same = a.dtype == b.dtype and a.shape == b.shape and (
                np.allclose(a, b, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL)
                if base == "pagerank" and f == "dist" else np.array_equal(a, b))
            _check(same, f"mesh D={d_n} {name}: {f} differs from the dense engine's")
        wire, sent = mesh_res["wire_msgs"], mesh_res["msgs_sent"].sum(axis=2)
        _check(bool((wire <= sent).all()) and wire.sum() > 0,
               f"mesh D={d_n} {name}: wire_msgs above the active remote edges in a superstep")
        for r, run in enumerate(runs):
            for step in run["record"]:
                iters = step["closure_iters"]
                want = dict(run["signature"], pmax_closure=run["signature"]["pmax_closure"] * iters)
                _check({k: v for k, v in step.items() if k != "closure_iters"} == want,
                       f"mesh D={d_n} {name} rank {r}: collectives {step} off the signature")
            # (ranks on the CPU, a rehearsal, run the plain version)
            holds = sum(run["plane_edges"].values()) > 0 and results.devices[r] != "cpu"
            _check(not holds or run["launches"] > 0,
                   f"mesh D={d_n} {name} rank {r} holds edges but launched the relax kernel "
                   "no time")
        out[name] = {
            "S": int(mesh_res["dist"].shape[0]),
            "supersteps": int(mesh_res["n_supersteps"].max()),
            "wire_msgs": int(wire.sum()), "active_remote_edges": int(sent.sum()),
            "wall_s": max(r["wall_s"] for r in runs),
            "engine_setup_s": max(r["setup_s"] for r in runs),
            "host_reads": runs[0]["host_reads"], "bulk_pulls": runs[0]["bulk_pulls"],
            "collective_share": [r["collective_s"] / r["wall_s"] for r in runs],
            "collective_calls": runs[0]["collective_calls"],
            "collective_bytes": [r["collective_bytes"] for r in runs],
            "peak_device_bytes": [r["peak_device_bytes"] for r in runs],
            "host_rss_bytes_after_setup_and_run": [r["host_rss_bytes"] for r in runs],
            "launches_by_rank": [r["launches"] for r in runs],
            "plane_edges_by_rank": [r["plane_edges"] for r in runs],
            "pads": runs[0]["pads"],
            "collectives_per_superstep": runs[0]["record"][:2],
        }
    return out


def phase_mesh(pg, runs: dict, bfs_trace, pred_tf, device, seed: int) -> dict:
    """LIVJ/8P on the multi-GPU engine, its D ranks sharing the card (see
    the module docstring); returns the ``mesh`` line and the relax kernel's
    launches per variant on this path."""
    t_phase = time.perf_counter()
    programs = _main_path_programs(pg, seed)
    n = pg.graph.n_vertices
    dense_cfg = EngineConfig(device=str(device), backend="cuda", m_max=MAX_SUPERSTEPS)
    dense = {}
    for name, prog, sources in programs:
        dense[name] = get_engine(pg, program=prog, config=dense_cfg).run(sources)
        d = dense[name].dist
        _check(np.allclose(d, runs[name]["dist"], rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL)
               if name == "pagerank" else np.array_equal(d, runs[name]["dist"]),
               f"the dense engine's {name} differs from the slice phase's")
    pg.__dict__.pop("_traversal_engines", None)
    torch.cuda.empty_cache()
    pel = partitioned_edge_layout(pg)
    indeg = np.bincount(pel.remote.dst, minlength=n)
    hub = int(indeg.argmax())
    mirror_degree = max(8, MESH_MIRROR_DEGREE >> _cut(int(np.log2(n))))
    hub_count = int((indeg >= mirror_degree).sum())
    _check(hub_count >= 1, f"no vertex reaches the mirror threshold {mirror_degree}")

    # the hub's rank at D = 8 holds the largest planes: the kernel is timed
    # there, at the shapes the engine hands it
    hub_rank = int(contiguous_device_map(pg.n_parts, MESH_SIZES[0])[pg.part_of_vertex[hub]])
    shared = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    ex_info = {"scale": int(np.log2(n))}
    if np.log2(n) > MESH_EXECUTOR_SCALE:
        # the executor's depth cut: its plan and the dense executor on a
        # smaller graph, shared beside the full one for the same launch
        t0 = time.perf_counter()
        xpg = build_graph(MESH_EXECUTOR_SCALE, pg.n_parts)[0]
        _, xtrace = bsp.run_sssp(xpg, 0, max_supersteps=MAX_SUPERSTEPS, collect_subgraphs=False,
                                 config=EngineConfig(device=str(device), backend="cuda"))
        ex = _mesh_executor_plan(xpg, xtrace, predict_time_function(xpg, 0)[0], device)
        share_graph(xpg, shared / "cut")
        ex["args"]["graph"] = str(shared / "cut")
        ex_info = {"scale": MESH_EXECUTOR_SCALE, "cut": {"scale": [int(np.log2(n)),
                                                                   MESH_EXECUTOR_SCALE]},
                   "cut_setup_s": time.perf_counter() - t0}
        del xpg
    else:
        ex = _mesh_executor_plan(pg, bfs_trace, pred_tf, device)

    bfs_sources = programs[0][2]
    jobs = list(programs)
    # D = 8: the three programs, the mirrored BFS, a swap re-layout and the
    # executor in one launch; D = 2: the three programs
    launches_plan = (
        ("D8", 8, [(None, jobs), (mirror_degree, [("bfs-mirror", BfsProgram(), bfs_sources)])],
         True, bfs_sources, (hub_rank, seed), ex["args"]),
        ("D2", 2, [(None, jobs)], False, None, None, None),
    )
    launches: dict = {v: 0 for v in VARIANTS}
    counts = {"kernel": 0, "engines": 0}  # partition counters' launches, summed over ranks
    launch_s, results, summary = {}, {}, {}
    with _HostMemory() as host_mem:
        try:
            t0 = time.perf_counter()
            host_mem.mark("before sharing")
            share_graph(pg, shared / "livj")
            share_s = time.perf_counter() - t0
            host_mem.mark("graph shared")
            for key, d_n, *rank_args in launches_plan:
                t0 = time.perf_counter()
                results[key] = run_ranks(_mesh_rank, d_n, device=device.type,
                                         timeout=MESH_LAUNCH_TIMEOUT_S,
                                         args=(str(shared / "livj"), *rank_args))
                launch_s[key] = time.perf_counter() - t0
                host_mem.mark(f"{key} ranks")
            ex_results = results["D8"]
            ex_info.update(planned_maps=ex["args"]["maps"], dense_wall_s=ex["dense_wall_s"])
        finally:
            shutil.rmtree(shared, ignore_errors=True)

    for key, d_n, *_ in launches_plan:
        res = results[key]
        _check(res.backend in ("gloo", "nccl"), f"unexpected backend {res.backend}")
        summary[key] = {
            "ranks": d_n, "backend": res.backend,
            "transport": res[0]["mesh"]["transport"], "devices": sorted(set(res.devices)),
            "layout_s": {md: max(r["layouts"][md]["seconds"] for r in res)
                         for md in res[0]["layouts"]},
            "layout_host_bytes": {md: max(r["layouts"][md]["host_bytes"] for r in res)
                                  for md in res[0]["layouts"]},
            "launch_s": launch_s[key],
            "rank_load_s": max(r["load_s"] for r in res),
            "rank_load_rss_bytes": max(r["load_rss_bytes"] for r in res),
            "programs": _check_mesh_runs(res, dense, d_n),
        }
        for r in res:
            for run in r["runs"].values():
                for v, c in run["variant_launches"].items():
                    launches[v] += c
                counts["kernel"] += run["part_count_launches"]
                counts["engines"] += run["part_count_launches_engine"]
    probe = results["D8"][0].get("gloo_cuda_probe")
    planes = results["D8"][hub_rank].get("kernel_planes", [])
    _check(device.type != "cuda" or len(planes) == 2,
           "the relax kernel was not held at the hub rank's planes")
    mir = results["D8"][0]["runs"]["bfs-mirror"]["result"]
    plain = results["D8"][0]["runs"]["bfs"]["result"]
    _check(mir["wire_msgs"].sum() <= plain["wire_msgs"].sum(),
           "mirrored BFS put more on the wire than unmirrored")
    # -- the swap re-layout: incremental, exact ------------------------------
    swaps = [r["swap"] for r in results["D8"]]
    _check(all(sw["done"] for sw in swaps), "the swapped BFS did not converge")
    _check(np.array_equal(swaps[0]["dist"], dense["bfs"].dist),
           "the BFS re-laid out between windows differs from the dense engine's")
    _check(all(sw["build"]["incremental"] for sw in swaps),
           "a pad-stable swap was not rebuilt from the active layout")

    # -- the executor: relayout=True against the dense executor -------------
    reports = [r["executor"]["report"] for r in ex_results]
    rep = reports[0]
    dense_fields = _report_fields(ex["dense"])
    for k in dense_fields:
        if k in PHYSICAL_FIELDS:
            continue
        a, b = dense_fields[k], rep[k]
        same = (a.dtype == b.dtype and np.array_equal(a, b)) if isinstance(a, np.ndarray) else a == b
        _check(same, f"mesh executor: ExecutionReport.{k} differs from the dense run's")
    for r, other in enumerate(reports[1:], start=1):
        _check(all(np.array_equal(other[k], rep[k]) if isinstance(rep[k], np.ndarray)
                   else other[k] == rep[k] for k in rep), f"mesh executor: rank {r}'s report differs")
    _check(rep["device_moves"] > 0, "the mesh executor moved no shard between ranks")
    _check(rep["relayouts"] > 0, "the mesh executor never re-laid the mesh out")
    _check(rep["replans"] == 0, "the FFD plan re-planned; residency cannot be held to it")
    plan_rows = ex["args"]["plan"].vm_of
    for w, row in enumerate(rep["residency"][: plan_rows.shape[0]]):
        placed = plan_rows[w] >= 0
        _check(np.array_equal(row[placed], device_of_vm(plan_rows[w][placed], 8)),
               f"mesh executor: window {w}'s residency is off the plan")
    for r in ex_results:
        for v, c in r["executor"]["variant_launches"].items():
            launches[v] += c
        counts["kernel"] += r["executor"]["part_count_launches"]
        counts["engines"] += r["executor"]["line"]["part_count_launches_engine"]
    line = ex_results[0]["executor"]["line"]
    builds = [r["executor"]["line"]["relayout_builds"] for r in ex_results]
    summary["executor"] = {
        **ex_info, "ranks": 8, "window": 1, "relayout": True,
        "relayouts": rep["relayouts"], "device_moves": rep["device_moves"],
        "device_move_bytes": rep["device_move_bytes"], "migrations": rep["n_migrations"],
        "supersteps": rep["n_supersteps"], "cost_quanta": rep["cost"]["cost_quanta"],
        "wall_s": line["wall_s"], "host_syncs_executor": line["host_syncs_executor"],
        "host_syncs_engine": line["host_syncs_engine"],
        "collective_share": line["collective_s"] / line["wall_s"],
        "relayout_s": max(sum(b["seconds"] for b in rank) for rank in builds),
        "relayout_builds_by_rank": builds,
        "host_rss_bytes": max(r["executor"]["host_rss_bytes"] for r in ex_results),
    }
    summary.update(
        hub={"vertex": hub, "remote_in_degree": int(indeg[hub]), "rank_at_d8": hub_rank,
             "mirror_degree": mirror_degree, "hub_count": hub_count,
             "wire_msgs_mirrored": int(mir["wire_msgs"].sum()),
             "wire_msgs_unmirrored": int(plain["wire_msgs"].sum())},
        swap={"after_supersteps": MESH_SWAP_AFTER, "wall_s": max(sw["wall_s"] for sw in swaps),
              "builds_by_rank": [sw["build"] for sw in swaps], "map_after": swaps[0]["map_after"]},
        share_s=share_s, kernel_planes=planes,
        gloo_cuda_probe=probe, host_memory=host_mem.report(),
        variant_launches=launches, part_count_launches=counts["kernel"],
        nvidia_smi=_nvidia_smi(),
        phase_s=time.perf_counter() - t_phase,
        note="one card time-sliced between D rank processes; gloo copies the CUDA payloads "
             "through host memory",
    )
    _check(device.type != "cuda" or sum(launches.values()) > 0,
           "the mesh path launched the relax kernel no time")
    _check_part_count_launches(counts["kernel"], counts["engines"], device, "the mesh path")
    return summary


def phase_analysis(pg, device, seed: int) -> dict:
    """The port's analysis layer on the card (``repro_torch.analysis``):
    ``audit_tree`` on the small audit graph -- every program on both
    backends, dense and on ``ANALYSIS_MESH_RANKS`` ranks sharing the card
    (unmirrored and mirrored, with the relayout sweep), the layout budgets
    and the delta cycle; JX01 on one LIVJ/8P BFS window of the slice's
    engine, its reads and transfers equal to the synchronizing calls
    ``set_sync_debug_mode("warn")`` counts in the same window; each kernel
    wrapper launched into poisoned memory; and two controls that must be
    flagged: a window with one extra ``.item()``, and a wrapper that leaves
    rows unwritten.  Any finding fails the run."""
    small = trace_audit.default_audit_graph()
    seconds, tree = {}, {}

    t0 = time.perf_counter()
    findings = trace_audit.audit_tree(small, device=device, d_n=ANALYSIS_MESH_RANKS, summary=tree)
    seconds["tree"] = time.perf_counter() - t0
    mesh = tree["mesh"]
    for key, rows in [*tree["dense"].items(),
                      *((c["label"], c["stats_rank0"]) for c in mesh["cases"])]:
        if "/cuda" in key:
            _check(all(r["launches"] > 0 for r in rows)
                   and not any(r["partition_launches"] for r in rows[1:]),
                   f"{key}: a window of the cuda backend launched no relax kernel, or a "
                   f"later one split a row_ptr again: {rows}")

    t0 = time.perf_counter()
    engine = get_engine(pg, program=BfsProgram(), config=EngineConfig(
        device=str(device), backend="cuda", m_max=MAX_SUPERSTEPS))
    state = engine.init_state(_main_path_programs(pg, seed)[0][2])
    torch.cuda.synchronize()
    (f, livj, _), syncs = trace_audit.synchronizing_calls(
        lambda: trace_audit.audit_window(engine, state, ANALYSIS_LIVJ_WINDOW, "livj/bfs/cuda"))
    findings += f
    livj = {k: v for k, v in livj.items() if k != "events"}
    _check(syncs == livj["reads"] + livj["transfers"],
           f"sync debug counted {syncs} synchronizing calls in the LIVJ window, the audit "
           f"{livj['reads']} reads + {livj['transfers']} transfers")
    seconds["livj_window"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    f, poison = trace_audit.audit_poisoned_kernels(device, seed)
    findings += f
    _check(len(poison) == 7 and all(r["landed"] and r["poisoned_bytes"] > 0 for r in poison),
           f"the poison did not reach every case's output block: {poison}")
    seconds["poison"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    control = trace_audit.control_extra_read(small, "cuda", device=device)
    _check(any(c.rule == "JX01" and "uncounted host read" in c.message for c in control),
           f"the extra-.item() control was not flagged: {control}")
    (skip,) = [fx for fx in ANALYSIS_FIXTURES if fx.rule == "AL03"]
    skipped = skip.run(device)
    _check(any("poisoned memory" in c.message for c in skipped),
           f"the skipped-rows wrapper was not caught under poisoned memory: {skipped}")
    seconds["controls"] = time.perf_counter() - t0

    _check(not findings, f"{len(findings)} analysis finding(s):\n{render_findings(findings)}")
    fields = ("reads", "transfers", "pulls", "ops", "inner_iters", "launches",
              "partition_launches", "grid_checks")
    return {
        "graph": {"n": small.graph.n_vertices, "E": small.graph.n_edges, "parts": small.n_parts},
        "windows": trace_audit.AUDIT_WINDOWS,
        "findings": len(findings),
        "dense": {k: [{f: r[f] for f in fields} for r in rows]
                  for k, rows in tree["dense"].items()},
        "livj_window": {**livj, "k": ANALYSIS_LIVJ_WINDOW, "sync_debug_calls": syncs},
        "transfers_per_pull": livj["transfers_per_pull"],
        "mesh": {"ranks": mesh["ranks"], "backend": mesh["backend"],
                 "launch_s": mesh["launch_s"], "sweep": mesh["sweep"],
                 "cases": [{"label": c["label"], "mirrored": c["mirrored"],
                            "collectives": c["collectives"],
                            "windows_rank0": [{f: r[f] for f in fields} for r in c["stats_rank0"]]}
                           for c in mesh["cases"]]},
        "poison": poison,
        "controls": {"extra_item": [str(c) for c in control],
                     "skipped_rows": [str(c) for c in skipped]},
        "seconds": seconds,
    }


def kernels_line(checks: dict, variant_launches: dict, seg: dict, flash: dict,
                 seg_livj: dict, path_launches: dict, mesh_planes: list, gnn: dict,
                 gnn_case: dict, lm: dict, recsys: dict, train_line: dict,
                 model_axis: dict, serve_mesh: dict, gnn_ranks: dict, counts: dict,
                 count_paths: dict) -> dict:
    """One entry per kernel the main path launched, with its numbers at the
    main path's own shape: the relax kernel's local closure reduction, the
    segment sum over uniform ids, the flash kernel at the Mixtral 32k
    window (the other cases of each are under ``cases``; the segment sum's
    LIVJ case has its own ``launches`` there, and its case at PNA's
    message is the gnn path's).  The relax entries also
    count their launches on the elastic, serving and mesh paths
    (``launches_by_path``, each read around its own path; the mesh path's
    summed over its ranks), and the float32-min entry its times at one
    mesh rank's planes (``mesh_planes``); the segment-sum entry its
    launches on its own path and the gnn path (every model's run, the halo
    ranks' summed), the recsys path (the ragged bag, its case under
    ``cases``), the train path (MeshGraphNet's straight run: every sum
    and every gather's gradient) and the gnn_ranks path (each case's step
    on the flattened axis, summed over the ranks); the flash entry its launches on the lm
    path (every GQA layer's prefill), the model_axis path (every GQA
    layer's prefill on each rank's heads, summed over the ranks) and each
    model's layer-0 case (the train path launches it no time: it has no
    backward).  The partition counters' entry holds the closure's call at a
    sparse frontier, its other cases under ``cases``, and its launches on
    the slice, elastic, serving and mesh paths (``count_paths``, each read
    around its own path and held to its engines' ``part_count_launches``;
    the mesh path's summed over its ranks)."""
    entries = []
    for variant, _, _, prog in MAIN_VARIANTS:
        cases = checks[variant]
        main, remote = cases[0], cases[1]
        entries.append({
            "name": f"relax_rowptr_kernel<{variant}>",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": variant_launches[variant],
            "launches_by_path": {"slice": variant_launches[variant],
                                 **{p: v[variant] for p, v in path_launches.items()}},
            "max_abs_err": max(c["max_abs_err"] for c in cases + (
                mesh_planes if variant == PATH_VARIANT else [])),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "program": prog,
            "shape": {"S": main["S"], "n": main["n"], "E": main["E"]},
            "ms_back_to_back": main["ms_back_to_back"],
            "main_remote": {k: remote[k] for k in ("S", "n", "E", "ms", "ms_back_to_back",
                                                    "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")},
            "held_against": [c["case"] for c in cases],
            **({"mesh_planes": [{k: c[k] for k in ("case", "S", "n", "E", "valid_edges", "ms",
                                                   "ms_back_to_back", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "max_abs_err")}
                                for c in mesh_planes]} if variant == PATH_VARIANT else {}),
        })
    for name, source, replaces, phase, launches in (
        ("segment_sum_level_kernel", SEG_SOURCE, SEG_REPLACES, seg, seg["launches"]),
        ("flash_fwd_wgmma_kernel", FLASH_SOURCE, FLASH_REPLACES, flash,
         flash["variant_launches"]["bfloat16-wgmma"]),
    ):
        main = phase["cases"][0]
        more = phase["cases"][1:] + (
            seg_livj["cases"] + [gnn_case, recsys["bag"]] if phase is seg
            else [m["attention"] for m in lm["models"] if m["attention"] is not None])
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": (
                {"segment_sum": launches, "gnn": gnn["launches"], "recsys": recsys["launches"],
                 "train": train_line["launches"], "gnn_ranks": gnn_ranks["launches"]}
                if phase is seg else {"flash_attention": launches, "lm": lm["launches"],
                                      "model_axis": model_axis["launches"],
                                      "serve_mesh": serve_mesh["launches"]}),
            "max_abs_err": max(c["max_abs_err"] for c in [main, *more, *phase["small"]]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library": main["library"],
            **({"variant": main["variant"]} if "variant" in main else {}),
            "shape": main.get("shape") or {k: main[k] for k in ("E", "N", "D")},
            "case": main["case"],
            "cut": phase["cut"],
            "cases": [{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")} for c in more],
        })
    main, *more = counts["cases"]
    entries.append({
        "name": "part_count_kernel",
        "route": "cuda",
        "source": PART_COUNT_SOURCE,
        "replaces": PART_COUNT_REPLACES,
        "launches": counts["launches"],
        "launches_by_path": {"part_count": counts["launches"], **count_paths},
        "max_abs_err": max(c["max_abs_err"] for c in counts["cases"]),
        **{k: main[k] for k in ("ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library", "case")},
        "shape": {k: main[k] for k in ("R", "n", "P", "W", "density")},
        "cases": [{k: c[k] for k in ("case", "ms", "ms_back_to_back", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")} for c in more],
    })
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--seed", type=int, default=0, help="seeds inputs and BFS sources")
    ap.add_argument("--out", default=None, help="also write the full report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs the port on an "
              "NVIDIA card and reports nothing without one", file=sys.stderr)
        return 2
    t_start = _last_emit[0] = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report = {}

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 products
    report["device"] = phase_device()
    _emit("device", report["device"])
    report["segment_sum"] = phase_segment_sum(device, args.seed, args.scale)
    _emit("segment_sum", report["segment_sum"])
    report["flash_attention"] = phase_flash(device, args.seed, args.scale)
    _emit("flash_attention", report["flash_attention"])
    report["lm"] = phase_lm(device, args.seed, args.scale)
    _emit("lm", report["lm"])
    report["recsys"] = phase_recsys(device, args.seed)
    _emit("recsys", report["recsys"])
    report["train"] = phase_train(device, args.seed)
    _emit("train", report["train"])
    (report["train_dp"], report["model_axis"], report["serve_mesh"],
     report["gnn_ranks"]) = phase_train_dp(device, args.seed, report["train"])
    _emit("train_dp", report["train_dp"])
    _emit("model_axis", report["model_axis"])
    _emit("serve_mesh", report["serve_mesh"])
    _emit("gnn_ranks", report["gnn_ranks"])
    report["dryrun"] = phase_dryrun()
    _emit("dryrun", report["dryrun"])
    pg, report["graph"] = build_graph(args.scale, LIVJ_PARTS)
    _emit("graph", report["graph"])
    report["gnn"], gnn_case = phase_gnn(pg, device, args.seed, args.scale)
    _emit("gnn", report["gnn"])
    report["segment_sum_livj"] = phase_segment_sum_livj(pg, device, args.seed)
    _emit("segment_sum_livj", report["segment_sum_livj"])
    checks = phase_kernels(pg, args.seed, device)
    report["kernel"] = checks
    _emit("kernel", {"variants": checks})
    report["part_count"] = phase_part_count(pg, args.seed, device)
    _emit("part_count", report["part_count"])
    report["relax_phases"] = phase_relax_phases(pg, args.seed, device)
    _emit("relax_phases", report["relax_phases"])
    report["oracle"] = phase_oracles(device, args.seed)
    _emit("oracle", report["oracle"])
    report["slice"], runs = phase_slice(pg, device, args.seed)
    _emit("slice", report["slice"])
    bfs_trace = runs["bfs"]["traces"][0]
    report["pipeline"], pred_tf = phase_pipeline(pg, bfs_trace)
    _emit("pipeline", report["pipeline"])
    report["elastic"] = phase_elastic(pg, runs["bfs"]["dist"][0], bfs_trace, pred_tf, device,
                                      args.seed)
    _emit("elastic", report["elastic"])
    report["serve"] = phase_serve(pg, bfs_trace, device, args.seed)
    _emit("serve", report["serve"])
    report["profile"] = phase_profile(pg, device, args.seed)
    _emit("profile", report["profile"])
    report["relax_entries"] = phase_relax_entries(pg, args.seed, device)
    _emit("relax_entries", report["relax_entries"])
    report["mesh"] = phase_mesh(pg, runs, bfs_trace, pred_tf, device, args.seed)
    _emit("mesh", report["mesh"])
    report["analysis"] = phase_analysis(pg, device, args.seed)
    _emit("analysis", report["analysis"])
    report["kernels"] = kernels_line(
        checks, report["slice"]["variant_launches"], report["segment_sum"],
        report["flash_attention"], report["segment_sum_livj"],
        {path: report[path]["variant_launches"] for path in ("elastic", "serve", "mesh")},
        report["mesh"]["kernel_planes"], report["gnn"], gnn_case, report["lm"],
        report["recsys"], report["train"], report["model_axis"], report["serve_mesh"],
        report["gnn_ranks"], report["part_count"],
        {path: report[path]["part_count_launches"] for path in ("slice", "elastic", "serve",
                                                                "mesh")},
    )["kernels"]
    report["wall_s"] = time.perf_counter() - t_start
    report["phase_seconds"] = dict(PHASE_SECONDS)
    _emit("done", {"wall_s": report["wall_s"], "phase_seconds_each": dict(PHASE_SECONDS)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": report["kernels"]}))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
