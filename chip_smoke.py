#!/usr/bin/env python3
# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Smoke run of the PyTorch/CUDA port (``rayfed_tpu_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serving-only   # phases 1 and 7 alone
    python3 chip_smoke.py --async-only     # phases 1, 2 and 8 alone
    python3 chip_smoke.py --family-only    # phases 1, 2 and 9 alone
    python3 chip_smoke.py --privacy-only   # phases 1, 2 and 10 alone
    python3 chip_smoke.py --dma-only       # phases 1, 2 and 11 alone
    python3 chip_smoke.py --wide-only      # phases 1, 2 and 12 alone
    python3 chip_smoke.py --ops-only       # phases 1, 2 and 13 alone
    python3 chip_smoke.py --sharded-only   # phases 1, 2 and 14 alone
    python3 chip_smoke.py --multiproc-only # phases 1, 2 and 15 alone

The whole run has a budget: each phase prints its wall beside its
budget (``PHASE_BUDGET_S``, 600 s in all), each spawned party job its
processes' setup seconds (spawn, import, card context, model init,
``fed.init``, ``fed.shutdown``) apart from their work, and every party
job waits at most its join deadline (at most 240 s). A watchdog fails the
run ``WATCHDOG_S`` (900 s) after it starts, naming the phase still
running, and kills the run's child processes. The party processes are
forked from a forkserver that has torch and the port imported once.

Phases:

1. device: the card's name, count, power limit; TF32 off.
2. build: the Hopper kernels from ``rayfed_tpu_torch/csrc`` (nvcc, one
   process per source); each kernel's registers, spills, shared memory
   and resident blocks per SM at the flagship head dim and at D = 256,
   their own tile plan (no kernel may spill), and,
   where the toolkit's ``cuobjdump`` runs, the tensor-core (HMMA, HGMMA),
   FFMA, TMA (UTMALDG) and mbarrier (SYNCS) instructions in each kernel's
   SASS; the bf16 K1 and K3 at D = 256 must issue HGMMA, UTMALDG and
   SYNCS, the f32 K2 and K3 at D = 256 HMMA, UTMALDG and SYNCS.
3. kernels: each flash kernel against its plain PyTorch version on the
   card, the bf16 ones and the f32 ones, at the flagship attention shape
   and at small shapes (``q_offset > 0``, ``Sq < Sk``, ragged tiles, every
   head dim, D = 80 zero-padded to 128, B*H = 65536); at the flagship shape each f32 output (O, lse, dq, dk, dv)
   is also held to a tenth of the error of one TF32 product (the plain
   version run again with ``allow_tf32``), which an f32 kernel computing
   in TF32 fails; times of kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick only; its backend named)
   with CUDA events; FLOPs, bytes and the roofline bound.
4. slice: one federated transformer round loop at the flagship width —
   two parties ("alice", "bob") each take local AdamW steps through
   ``make_fed_train_step(attn="flash")``, ``tree_mean`` folds their params
   on the card, both load the aggregate, for a few rounds. Checks: every
   round starts from bitwise-identical trees, losses are finite, the
   aggregate's loss falls, flash and dense attention agree on it, and
   the train steps launched every bf16 kernel (the evaluations' launches
   are counted apart).
4b. f32: the same model in f32 (``compute_dtype=torch.float32``,
   ``attn="auto"``) at the same width and depth: a few AdamW steps, which
   must launch every f32 kernel, and one more profiled (device ms by
   kind, idle share); then, at batch 1, one step's loss and gradients
   against the dense attention's (``attn="xla"``).
5. fed: the same FedAvg round through the port's own engine, at the same
   width, depth ``PARTY_LAYERS``: ``alice`` and ``bob`` are spawned processes that
   ``fed.init`` over localhost TCP; a party-pinned ``LocalTrainer`` actor
   holds each party's params and AdamW state on the card, an
   ``aggregate`` task pinned to ``alice`` folds the trees with
   ``tree_mean``, ``fed.get`` brings the aggregate to both and each actor
   loads it in place, for two rounds. Checks: (a) every pushed tree
   arrives bitwise as its owner hashed it, (b) every round starts from
   identical params, (c) the receiver gets the pre-step bytes although
   the owner steps in place right after its push, (d) the aggregate's
   loss falls, (e) each party's train steps launch every bf16 kernel, (f)
   a bf16 tree crosses bitwise, (g) both parties ran the native IO path
   (``rayfed_tpu_torch._fastwire``). Prints each push's ms, GB/s and
   split, the IO path and each party's peak memory; then runs the phase
   once more, one round, with the parties on sockio's Python IO path and
   prints both splits side by side.
6. programs: the JAX package's FedAvg programs as the port's examples
   (``rayfed_tpu_torch/examples``), two spawned party processes each,
   with ``transport="cuda"``: ``federated_transformer.py`` at the same
   width and depth (``fed_aggregate`` mean, received trees placed on
   the party's card by the lane), then ``fedavg_cnn.py``
   (``FedAvgTrainer``, wmean over 640/384 shards), 2 rounds each.
   Checks: (a) every received tree is on the party's card in the
   consuming task, with no ``.to()`` there, (b) the root's aggregate on the
   card is bitwise the port's CPU fold of the two pushed trees, (c) both
   parties' final aggregates hash the same, (d) the aggregate's loss
   falls, (e) each party's steps launch every bf16 kernel, (f) both
   parties ran the native IO path; the CNN program's two digests agree.
   Prints each push's ms, GB/s and split (host staging, send, decode and
   the placement inside it), each round's wall and each party's peak
   memory.

7. serve: the serving plane (``rayfed_tpu_torch.serving``) at the
   flagship width, depth ``SERVE_LAYERS`` in the whole run and full depth
   with ``--serving-only`` (bf16 compute, f32 params from a seed,
   bf16 KV): an ``InferenceServer`` under ``SERVE_CFG`` (paged KV in
   16-position blocks, 8 slots), warmed on every program shape, answers
   32 greedy requests from 8 client threads, prompts of 16-512 tokens
   from a seed, a second version published after a third of the
   completions; the same traffic again in ``mode="sequential"``. Checks: (a) every response equals the same
   request served alone (``mode="sequential"``, same shape) on its
   pinned version, (b) the slab layout gives the paged layout's tokens on
   the same traffic without the swap, (c) a rerun gives the same tokens,
   (d) at f32 compute and 2 layers, the engine's prefill logits (whole
   and chunked) and first decode step within 1e-4 of a full forward's
   norm, (e) no request fails and the swap is counted. Prints the host's
   state (load, threads, a launch probe), TTFT p50 and p99, decode
   tokens/s, the median decode step and prefill chunk (CUDA events in
   both windows) and the live rows per step, the sequential window and
   the speedup, the publish's ms and zero-copy adoptions, the pool's
   bytes and peak memory, what the layouts' shared prefill shapes cost
   against the JAX package's, and one profiled paged decode iteration
   at a state the traffic reaches (device ms by kind, idle share). Then the two-process
   run at 4 layers: ``fed.serve("alice", ...)`` in two spawned parties,
   8 requests through the handle, a ``fed_aggregate(publish_to=handle)``
   mid-load; every response names its version and equals alice's
   reference for it. The serving path launches none of the flash
   kernels: cached decode runs the plain attention, as the JAX package's
   does.

8. async: FedBuff rounds, elastic membership and job checkpoints
   (``rayfed_tpu_torch.async_rounds``, ``membership``, ``checkpoint``) at
   the same width, depth ``PARTY_LAYERS``, three spawned party processes on the card
   with ``transport="cuda"``: alice is the async root (``async_buffer_k``
   2, the JAX package's other defaults), the membership coordinator and
   a serving engine each version publishes into; bob trains every round
   (two AdamW steps through the bf16 K1-K3), slowed by a seeded
   straggler schedule; carol starts outside the roster, ``fed.join``s once
   version 1 is out (her bootstrap is the bank's newest version), offers
   once and ``fed.leave``s. After version 2 alice cuts
   ``save_job_state`` (her model, the aggregator's buffer and round
   tags, the membership snapshot, the bank) and bob his model and AdamW
   state; an aggregator rebuilt from alice's ``restore_job_state`` takes
   the same next offers as the live one. Checks: (a) every version
   equals a CPU fold (``reduce_by_plan`` + ``tree_mix``) of the recorded
   offers in their arrival order, bitwise, (b) the rebuilt aggregator's
   next version equals the live one's bitwise, (c) every party saw the
   same view at each sync, the join and the leave landed as epoch bumps,
   carol's bootstrap is the bits of the version it names, (d) some
   contribution arrived stale, (e) the loss fell, (f) both cuts restore
   bitwise, (g) every version reached the bank, (h) the trainers
   launched every bf16 kernel; every party exits 0. Prints per version
   k, each contribution's staleness and weight, the fold's and the
   publish's ms (CUDA events), each offer's push, the join and leave
   ms, each cut's bytes and save and restore ms, each party's peak
   memory.

9. family: the rest of the transformer family at the same width and
   depth. (a) An MoE model (each FFN a top-1 MoE FFN of 8 experts, each
   d_ff wide; the repo has no MoE configuration, so this is an
   assumption) takes 3 AdamW steps through ``make_fed_train_step(attn=
   "flash", remat="attn")``, then 2 each under ``remat=False`` and
   ``True``: finite losses, K1-K3 launched; per mode the step ms,
   tokens/s, peak memory and K1 launches per step. At depth 2, batch 2
   the three modes' loss and gradients are bitwise equal. (c) Cached
   decoding of the MoE model: at f32 compute and depth 2 the prefill's and
   each decode step's logits within 1e-4 of a full forward's norm and the
   greedy tokens those of ``make_generate_fn``; greedy tokens of the bf16
   model of (a), the same on a rerun; sampled tokens of that model
   (temperature 0.8, top_k 40, ``jax.random.categorical`` over threefry):
   the same key gives the same tokens twice, each lies in the top-k of
   its position's replayed logits, and the key's threefry ``uniform`` and
   ``gumbel`` words on the card equal the CPU's bitwise. (b)
   ``examples/fedavg_lora.py`` on
   the dense model at depth ``PARTY_LAYERS`` in two spawned party
   processes, ``transport="cuda"``, rank 8 on the attention targets, one
   round of 3 local steps at batch 12: the merged models hash the same in
   both parties every round, the
   root's aggregate is bitwise the CPU fold of the two pushed adapter
   trees, the frozen base is bitwise unchanged, each party launched K1-K3.
   Prints the adapter bytes pushed a round against the base's, each
   round's wall, each party's launches and peak memory.

10. privacy: secure aggregation (``rayfed_tpu_torch.privacy``,
   ``fed_aggregate(secure=True)``) at the same width, depth ``PARTY_LAYERS``, three
   spawned party processes on the card with ``transport="cuda"`` and
   ``config["privacy"]``: each party takes one bf16 AdamW step (batch
   cut to 4, so the three share the card), then alice folds the three
   trained param trees in a plaintext and a secure mean. Checks: (a) in
   each party, the mask words the card added to the largest leaf
   (masked minus encoded) at its first and last 2**20 flat indices equal
   the CPU plain path's threefry words bitwise, (b) the ring sum of the
   three masked envelopes equals the ring sum of the three plain
   encodings bitwise (the masks cancel), (c) the secure mean is within
   2**-(f+1) (f = 16) plus eight f32 epsilons of the entries' mean
   magnitude of the plaintext ``tree_mean``, (d) over grid-valued copies
   of the trees (multiples of 2**-16) the secure mean is the plaintext
   fold's bits, (e) a secure round with carol's envelope withheld,
   followed by alice's and bob's ``reoffer_seeds``, gives the survivors'
   plaintext mean bitwise, (f) one secure ``async_round`` at
   ``buffer_k`` 2 folds the three masked offers into version 1, bitwise
   (d)'s mean; each party launched every bf16 kernel. Prints per party
   each partner's mask stream ms and GB/s of words and the encode ms,
   alice's ring sum and decode ms, the secure round's wall against the
   plaintext round's of the same trees, and each party's peak memory in
   the step and in the rounds. Then the same three processes
   ``fed.shutdown`` and ``fed.init`` a second job, ``smoke-dp``: the
   privacy config adds ``clip_norm`` (a quarter of the initial tree's
   norm, so the clip acts), ``noise_multiplier`` 1.1, ``noise_seed`` and
   ``quantize="int8"``, with ``payload_wire_dtype="int8"``; each party
   takes two bf16 steps (every bf16 kernel launched, counted in the
   kernel line), then a secure DP mean at alice. Checks: (g) each
   party's clipped tree on the card equals the CPU port's clip of the
   same tree bitwise, (h) at alice the DP mean against the un-noised
   mean of the same envelopes is the noise: at the first and last 2**20
   entries of the largest leaf the CPU port's draws bitwise; over every
   entry noise / stddev has a mean within 5 standard errors of 0 and a
   standard deviation within 5 of 1; a second draw of the same (seed,
   round) gives the same bits; ``fed.privacy_ledger()`` charges each
   party one round of ``sqrt(2 ln(1.25/delta)) / z``; (i) bob's f32 tree
   pushed to alice under the int8 tier arrives as the CPU port's
   ``dequantize_tree(quantize_tree(tree))`` bitwise, its frame's bulk
   bytes a quarter of the f32 bytes and ``quantized_bytes_saved`` up by
   three quarters. Prints the clip's, the noise's and the push's ms
   (beside phase 5's f32 push) and the moments.

11. dma: the device-DMA push lane (``rayfed_tpu_torch/proxy/cuda/dma.py``),
   two spawned party processes on the card with ``transport="cuda"`` and
   ``cross_silo_comm.device_dma``: a pushed tree whose every leaf is on
   the card is snapshotted there into one ``cudaMalloc`` buffer when it
   resolves, only a descriptor crosses the socket, and the receiver
   pulls it by CUDA IPC. (a) Phase 5's round program at its width, depth
   and batch, one round (``DMA_ROUNDS``): its checks (a)-(g), and every
   params, aggregate and bf16
   push pulled by the ``ipc`` engine, none by another; the root's
   aggregate on the card bitwise the CPU fold of the two trees; each
   sender's lane holds no snapshot after the pulls. (b) A 4 MiB tree
   (bob's first pull, which brings up his CUDA context and the lane's
   library), then one push of the flagship f32 tree at full depth and at
   its initialization, alice to bob: bitwise, by ``ipc``; the card's
   free memory after the pull, less what the parties' allocators took
   meanwhile, within 64 MiB of before it (the snapshot is outside
   PyTorch's allocator), and the owner's lane empty. (c)
   ``examples/split_learning.py`` as on the card, 10 steps: the loss
   falls, every activation and gradient push by ``ipc``. (d) A tree
   with a string leaf rides the socket lane. Prints each push's ms
   (from the owner's capture to the receiver's tensors on its card),
   GB/s, its ``stage`` (the snapshot), ``send``
   (the descriptor) and ``pull`` spans (the pull's request, allocation,
   IPC open, copy and close) beside the bound of two device copies, the
   split-learning ms a step, and phase 5's native push of the same run.

12. wide: the flagship width in 8 heads of 256 (``WIDE``, Gemma 2B's
   query layout), depth cut as phase 4's, through the kernels' D = 256
   tile plans. (b) Each D = 256 kernel, bf16 and f32, against its plain
   version at D = 136, 160 and 192 (zero-padded to 256) and 256, with
   ``q_offset > 0``, ``Sq < Sk``, ragged tiles and B*H = 65536, then at
   B=12, S=2048, H=8, D=256 (f32 with the exact-f32 reading) timed beside
   its plain version and SDPA (its backend named), with FLOPs, bytes and
   the bound. (c) Phase 4's round loop at ``WIDE``: its checks, and the
   train steps launch every bf16 D = 256 kernel and no D <= 128 one. (d)
   Phase 6's transformer program at ``WIDE``, depth ``PARTY_LAYERS``, in
   two party processes with ``transport="cuda"``: its checks (a)-(f), the root's aggregate bitwise
   the CPU fold of the two pushed trees, each party's steps on the D =
   256 kernels alone. (e) Phase 4b at ``WIDE`` (f32 steps, the batch-1
   loss and gradients against the dense attention's), then one round of
   phase 4's loop in f32: their steps launch every f32 D = 256 kernel and
   no f32 D <= 128 one. Prints each part's wall.

13. ops: the engine's operational planes around the flagship round, at
   phase 4's width, depth ``PARTY_LAYERS``: two spawned party processes on the card
   over mutual TLS on the TCP lane (certificates from
   ``tools/generate_tls_certs.py``), telemetry on (the collector at
   alice, 150 ms pushes, an HTTP endpoint), and a seeded fault schedule
   (``ops_schedule``: the chaos schedule of ``tests/test_resilience.py``
   cut to three rounds: a delay and a drop of alice's pushes, a one-way
   partition of alice->bob, a corrupt rule on alice's second push, and
   one on bob's third with frame crc on his link, which is NACKed and
   sent again). Each round each party takes one bf16 step (K1-K3),
   pushes its tree, ``fed.get(on_missing="default")`` brings both, and
   ``elastic_weighted_mean`` folds the survivors on the card; then the
   same processes run the job again with the same seed at a small tree
   on the CPU. Checks (a)-(i) of :func:`phase_ops`: bob DEAD in alice's
   view, each fold bitwise the CPU's at sampled entries, the corrupted
   push one bit per leaf off (the CPU injector's bit, and the same flip
   on the card stays there), every other push bitwise, both fault
   traces byte-identical across the two jobs, the collector's counts of
   faults, sends and the crc resend, ``/metrics`` of both parties, a
   stitched fleet trace, K1-K3 launched. Prints each round's wall and
   fold, each TLS push's ms, GB/s and split (stage, send, decode,
   place), the step ms and each party's peak memory.

14. sharded: ``make_fed_train_step`` over a party x data x model
   DeviceMesh (``mesh.build_mesh``) of one rank, a one-process NCCL
   group on the card, at phase 4's width, depth and seed: params are
   DTensors placed by the Megatron rules and the flash kernels run under
   their DTensor rule. Checks (a)-(e) of :func:`phase_sharded`: five
   steps bitwise the one-device step's (losses and params), the same
   with ZeRO-1 and ``accum_steps=2``, K1-K3 launched as often as by the
   one-device steps, and a sharded greedy decode equal to the
   one-device one. Prints each run's step ms and peak memory beside the
   one-device run's. One card shows only that the DTensor path and the
   kernels compose and what the dispatch costs: tensor and data
   parallelism over more than one rank are held on the CPU (gloo,
   ``tests/test_torch_parallel.py``).

15. multiproc: a party over two processes (``config["jax_distributed"]``,
   :func:`rayfed_tpu_torch.mesh.init_distributed`) at the flagship width,
   depth ``PARTY_LAYERS``: alice's leader and follower share the card in a
   gloo party group with a ``data = 2`` party mesh, bob is one process,
   all on ``transport="cuda"``. Checks (a)-(f) of :func:`phase_multiproc`:
   each of alice's processes takes one data-parallel bf16 step on half of
   phase 4's batch (K1-K3 launched in each), their params bitwise equal
   and the loss within 1e-5 and the gradient (each leaf's first AdamW
   moment) within 2e-2 in relative norm of a one-process step over the
   whole batch; the leader's push reaches bob bitwise, one frame an
   edge; bob's tree reaches both of alice's processes bitwise (the
   follower's through the leader's relay: keys in the party group's
   store, the bytes point to point over its gloo group), placed on the card as
   replicated DTensors; the aggregate is the same in both and bitwise the
   CPU fold; bob's error reaches both as ``FedRemoteError``; no relay key
   is left. Prints the relay's ms and GB/s and each process's step ms.

Every phase prints its wall seconds and its budget. It needs a CUDA card and exits
non-zero without one. The last two lines are the kernel table (twelve
kernels: K1-K3 in bf16 and in f32, each up to D = 128 and at D = 256)
and ``{"ok": true, "device": {...}}`` as JSON.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

REPO = os.path.dirname(os.path.abspath(__file__))

# The flagship width: benchmarks/transformer_train_benchmark.py FLAGSHIP
# (d_model 2048, 12 layers, seq 2048, vocab 32768; its batch 12) with that
# script's rules n_heads = d_model // 128 and d_ff = int(2.75 d) // 16 * 16.
FLAGSHIP = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=12,
                d_ff=5632, seq=2048, batch=12)
# What this run cuts to stay well inside its time limit: depth only.
# The one-process phases (4, 4b, 9 (a), 12 (c) and (e), 14) run
# SMOKE_LAYERS; the phases of spawned party processes (5, 6, 8, 9 (b), 10,
# 11 (a), 12 (d), 13, 15) run PARTY_LAYERS, which keeps the flagship width
# and every stacked (n_layers, ...) leaf (their numbers are not
# comparable with runs of those phases at depth 4).
SMOKE_LAYERS = 4
PARTY_LAYERS = 1
# Phase 12: the flagship width in 8 heads of 256, Gemma 2B's query layout
# (hidden_size 2048, num_attention_heads 8, head_dim 256 in Google's
# published gemma-2b config; only the shape is taken). H*D is the
# flagship's, so each flash kernel does the flagship's FLOPs at D = 256.
WIDE = dict(FLAGSHIP, n_heads=8)
WIDE_HEAD_DIM = WIDE["d_model"] // WIDE["n_heads"]

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Exact f32 has two routes (H100 SXM data sheet): FFMA on the CUDA cores,
# or each product split into three TF32 products on the tensor cores; an
# f32 kernel's bound takes the faster.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# Tolerances, kernel vs plain version on the same bf16 inputs. A bf16
# output (O, dq, dk, dv) is cut along the sequence into TILE-row tiles;
# in each tile the error's norm over (batch, rows, heads, dim) must stay
# within BF16_TILE_REL_TOL of the plain version's norm there. The two
# differ where the online softmax rounds P and dS to bf16 (64-wide tiles
# in the kernel, the plain version's blocks), about one bf16 ulp; a tile
# of keys or queries skipped for some rows moves those rows' tiles by
# far more (PERF.md holds both readings). A max-norm limit would not do:
# the first rows and keys hold the largest values, most entries are
# small. lse and delta (f32) are held by absolute error.
TILE = 64
BF16_TILE_REL_TOL = 1e-2
F32_STAT_TOL = 1e-3
# The f32 kernels are held as the JAX package's tests hold its f32
# kernels (tests/test_flash_attention.py): O to 2e-5 and the gradients to
# 3e-4, absolute; they round nothing between products, so only the order
# of f32 sums differs from the plain version's. lse and delta, f32 in both
# paths, are held tighter than the bf16 path's.
F32_OUT_TOL = 2e-5
F32_GRAD_TOL = 3e-4
F32_KERNEL_STAT_TOL = 1e-4
# Exact f32: at the main path's shape each f32 output's error is held to
# this fraction of the error of one TF32 product per f32 product (the
# plain version with ``allow_tf32``, on the same inputs). The f32 K1-K3
# multiply on the tensor cores as three TF32 products each; a kernel
# that issued one fails this limit whatever the size of its error against
# the limits above (at the main path's shape it also fails 3e-4, on small
# inputs it can pass it).
EXACT_F32_FRACTION = 0.1
# Phase 4b, batch 1: the f32 model with the f32 kernels against the dense
# attention, one step's loss (relative) and each gradient leaf (its
# difference's norm over its norm).
F32_LOSS_RTOL = 1e-4
F32_GRAD_RTOL = 1e-3
# Loss of the aggregate with flash vs dense attention (bf16 compute).
ATTN_LOSS_TOL = 2e-2
# The federation of phase 4: each party's name and data seed.
PARTIES = (("alice", 1), ("bob", 2))

# Each TPU kernel (rayfed_tpu/ops/flash_attention.py) takes bf16 or f32
# and any head dim; the port has a Hopper kernel for each dtype, each in
# two tile plans (head dims up to 128, and 256), each counted apart
# (``flash_attention.LAUNCHES``). The bf16 K1 and K3 and the f32 K2 and K3
# at D = 256 are warp-specialised kernels in a source of their own each
# dtype.
D256_SOURCE_KERNELS = ("flash_fwd_d256", "flash_bwd_dkv_d256")
F32_D256_SOURCE_KERNELS = ("flash_bwd_dq_f32_d256", "flash_bwd_dkv_f32_d256")


def _kernel_source(name, dtype_src):
    own = "_d256" if name in D256_SOURCE_KERNELS else \
        "_f32_d256" if name in F32_D256_SOURCE_KERNELS else dtype_src
    return f"rayfed_tpu_torch/csrc/flash_attention{own}.cu"


KERNELS = [
    dict(name=name + sfx, route="cuda", source=_kernel_source(name + sfx, src),
         replaces=f"rayfed_tpu/ops/flash_attention.py:{line}")
    for sfx, src in (("", ""), ("_d256", ""), ("_f32", "_f32"),
                     ("_f32_d256", "_f32"))
    for name, line in (("flash_fwd", 51), ("flash_bwd_dq", 151),
                       ("flash_bwd_dkv", 200))
]
BF16_KERNELS = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
WIDE_KERNELS = [n + "_d256" for n in BF16_KERNELS]
F32_KERNELS = [n + "_f32" for n in BF16_KERNELS]
F32_WIDE_KERNELS = [n + "_f32_d256" for n in BF16_KERNELS]


class SmokeError(RuntimeError):
    """A phase's check failed."""


def require(cond, what):
    if not cond:
        raise SmokeError(what)


# ---------------------------------------------------------------------------
# The run's budget: each phase's seconds, a watchdog over the whole run
# ---------------------------------------------------------------------------

#: Seconds each phase of the whole run may take: the sum is the run's
#: budget (PERF.md section 5 holds each phase's measured walls beside it).
#: A phase over its budget is printed as such; the watchdog and each
#: phase's join deadlines are what fail a run.
PHASE_BUDGET_S = {1: 2, 2: 32, 3: 19, 4: 4, "4b": 7, 5: 45, 6: 45, 7: 35,
                  8: 70, 9: 32, 10: 60, 11: 32, 12: 90, 13: 75, 14: 14,
                  15: 35}
#: The whole run fails this many seconds after ``main`` starts, naming the
#: phase still running, before any outer clock cuts it with nothing said.
WATCHDOG_S = 900
#: Seconds every ``torch.distributed`` wait of the run may take.
DIST_TIMEOUT_S = 120
# The phase that ``_phase_begin`` last set, which the watchdog names.
_running = {"phase": None}


def _phase_begin(n):
    """Mark phase ``n`` as running (the watchdog names it); its start."""
    _running["phase"] = n
    return time.perf_counter()


def _phase_wall(n, t0, smi):
    wall = time.perf_counter() - t0
    budget = PHASE_BUDGET_S.get(n)
    over = "" if budget is None or wall <= budget else ", OVER BUDGET"
    print(f"[phase {n}] {wall:.1f} s (budget {budget} s{over}) on {smi}")


def start_watchdog(limit_s=WATCHDOG_S):
    """A daemon thread that fails the run ``limit_s`` seconds from now:
    it names the running phase on stderr, kills every live child process
    and exits with code 1. Returns an event that stops it when set."""
    import threading

    done = threading.Event()

    def watch():
        if done.wait(limit_s):
            return
        print(f"chip_smoke: FAILED: phase {_running['phase']} still running "
              f"after {limit_s:g} s", file=sys.stderr, flush=True)
        import multiprocessing

        for child in multiprocessing.active_children():
            child.kill()
        os._exit(1)

    threading.Thread(target=watch, name="chip-smoke-watchdog",
                     daemon=True).start()
    return done


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: chip_smoke.py runs the port on a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(smi)
    return name, smi


# ---------------------------------------------------------------------------
# Phase 2: build
# ---------------------------------------------------------------------------


def phase_build(head_dim):
    """Build the kernels; print the compiler's report and, for each kernel
    at ``head_dim`` and at ``WIDE_HEAD_DIM`` (its own tile plan), the
    resources the card gives it. Fails if any of them spills registers."""
    from rayfed_tpu_torch.ops import _native

    t0 = time.perf_counter()
    path = _native.build()
    _native.lib()
    secs = time.perf_counter() - t0
    print(f"[build] {os.path.relpath(path, REPO)} in {secs:.1f}s")
    with open(path + ".log") as f:
        log = f.read()
    for line in ptxas_report(log):
        print(f"[build] {line}")
    counts = sass_counts(path, SASS_OPS + TMA_SASS_OPS)
    if counts is None:
        print("[build] SASS instruction counts: no cuobjdump in the toolkit")
    for d in (head_dim, WIDE_HEAD_DIM):
        resources = kernel_resources(log, d)
        for name, res in resources.items():
            print(f"[build] {name}<{d}>: {res['registers']} registers, "
                  f"{res['spill_bytes']} spill bytes, {res['smem_bytes']} B "
                  f"dynamic shared memory, {res['threads']} threads, "
                  f"{res['blocks_per_sm']} resident blocks per SM")
        print(json.dumps({"resources": {"head_dim": d, **resources}}))
        for name in resources:
            require(resources[name]["spill_bytes"] == 0,
                    f"{name}<{d}> spills: {resources[name]}")
        for name in resources if counts is not None else ():
            c = counts.get(f"{name}<{d}>", {})
            print(f"[build] {name}<{d}> SASS: " + ", ".join(
                f"{c.get(op, 0)} {op}" for op in SASS_OPS + TMA_SASS_OPS))
            tensor_op = WARP_SPECIALISED_D256.get(name)
            if d == WIDE_HEAD_DIM and tensor_op:
                require(all(c.get(op, 0) for op in (tensor_op,)
                            + TMA_SASS_OPS),
                        f"{name}<{d}> is not the warp-specialised TMA "
                        f"kernel: SASS {c}")
    return secs


KERNEL_RE = r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_f32)?_kernel)ILi(\d+)E"
# Tensor-core products (mma.sync, wgmma) and CUDA-core f32 multiply-adds.
SASS_OPS = ("HMMA", "HGMMA", "FFMA")
# TMA tensor copies and mbarrier operations: the warp-specialised kernels
# at D = 256 must issue both, beside their tensor-core products (bf16 K1
# and K3 wgmma, f32 K2 and K3 mma.sync).
TMA_SASS_OPS = ("UTMALDG", "SYNCS")
WARP_SPECIALISED_D256 = {
    "flash_fwd_kernel": "HGMMA", "flash_bwd_dkv_kernel": "HGMMA",
    "flash_bwd_dq_f32_kernel": "HMMA", "flash_bwd_dkv_f32_kernel": "HMMA"}


def sass_counts(path, ops=SASS_OPS):
    """{"kernel<D>": {op: instructions}} for ``ops`` in the SASS of the
    library at ``path`` (``cuobjdump -sass``); None where the toolkit has
    no ``cuobjdump`` or it fails."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    return parse_sass_counts(out.stdout, ops)


def parse_sass_counts(sass, ops=SASS_OPS):
    """:func:`sass_counts` from the text of ``cuobjdump -sass``."""
    counts, kernel = {}, None
    pattern = re.compile(r"\b(" + "|".join(ops) + r")\b")
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(KERNEL_RE, line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else None
            if kernel:
                counts.setdefault(kernel, dict.fromkeys(ops, 0))
        elif kernel:
            m = pattern.search(line)
            if m:
                counts[kernel][m.group(1)] += 1
    return counts


def kernel_resources(log, head_dim, names=None):
    """{kernel: resources at ``head_dim``} for ``names`` (every kernel by
    default): what the card gives it (``_native.kernel_resources``) and
    its spill bytes from the compiler's report ``log``."""
    from rayfed_tpu_torch.ops import _native

    spills = ptxas_spills(log)
    return {name: dict(_native.kernel_resources(name, head_dim),
                       spill_bytes=spills.get(f"{name}<{head_dim}>"))
            for name in names or _native.KERNEL_NAMES}


def ptxas_report(log):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``; the
    lines of an entry function that is no flash kernel go under "?"."""
    out, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(KERNEL_RE, line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "Compiling entry function" in line:
            kernel = "?"
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: " + line.split(":", 1)[-1].strip())
    return out


def ptxas_spills(log):
    """{"kernel<D>": spill store + load bytes} from ``nvcc -Xptxas -v``."""
    out = {}
    for line in ptxas_report(log):
        kernel, _, rest = line.partition(": ")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      rest)
        if m:
            out[kernel] = int(m.group(1)) + int(m.group(2))
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def causal_pairs(b, sq, sk, h, q_offset):
    """(query, key) pairs the causal mask keeps, over batch and heads."""
    return b * h * sum(min(q_offset + i + 1, sk) for i in range(sq))


def kernel_work(b, sq, sk, h, d, q_offset, elem=2):
    """FLOPs and bytes each kernel needs on these shapes: 2*D FLOPs per
    kept (q, k) pair per matmul (K1 2 matmuls, K2 3, K3 4); bytes count
    each input read once and each output written once, q/k/v/o/do and
    their gradients ``elem`` bytes an element (2 in bf16, 4 in f32)."""
    pairs = causal_pairs(b, sq, sk, h, q_offset)
    rq, rk, st = b * sq * h * d * elem, b * sk * h * d * elem, b * sq * h * 4
    return {
        "flash_fwd": (4 * d * pairs, rq + 2 * rk + rq + st),
        "flash_bwd_dq": (6 * d * pairs, 3 * rq + 2 * rk + rq + 2 * st),
        "flash_bwd_dkv": (8 * d * pairs, 2 * rq + 2 * rk + 2 * rk + 2 * st),
    }


def bound(flops, nbytes, dtype):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the card's rate for ``dtype``
    (bf16 on the tensor cores; f32 exactly, by the faster of FFMA and
    three TF32 products)."""
    if dtype == "bfloat16":
        t_ops = flops / PEAK_BF16_FLOPS
    else:
        t_ops = min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(device, b, sq, sk, h, d, seed, dtype="bfloat16"):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g, device=device).to(
            getattr(torch, dtype))

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def tile_rel_err(got, want):
    """Largest over the TILE-row tiles of the sequence (dim 1) of
    ||got - want|| / ||want||, each norm over the whole tile."""
    import torch

    errs = []
    for g, w in zip(torch.split(got.float(), TILE, dim=1),
                    torch.split(want.float(), TILE, dim=1)):
        errs.append(float(torch.linalg.vector_norm(g - w)
                          / torch.linalg.vector_norm(w).clamp(min=1e-30)))
    return max(errs)


def abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def kernel_errors(device, b, sq, sk, h, d, q_offset, seed=0,
                  dtype="bfloat16", exact_f32=False):
    """Each kernel of ``dtype`` ("bfloat16" or "float32") against its
    plain version on the same inputs (K2 and K3 fed the plain version's o,
    lse and delta). The plain version runs its f32 products in full f32
    (TF32 off). Returns ({output: (reading, limit)}, {kernel: max abs
    err}, inputs); a reading of NaN is a failure. bf16 outputs are read
    by :func:`tile_rel_err`, f32 ones by their largest absolute error.
    With ``exact_f32`` (f32 only) the plain version runs once more with
    TF32 on, and each output's reading "<kernel> f32 <output> exact"
    ("<kernel> f32 d256 <output> exact" on the D = 256 plan) is its error
    against a limit of ``EXACT_F32_FRACTION`` times that TF32 run's error;
    TF32 is off again before anything else runs."""
    import torch

    from rayfed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _inputs(device, b, sq, sk, h, d, seed, dtype)
    bq, bk = fa._pow2_block(sq, 512), fa._pow2_block(sk, 512)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
    dq_ref, delta_ref = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do,
                                               bq, bk, q_offset)
    dk_ref, dv_ref = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta_ref,
                                             bq, bk, q_offset)
    o, lse = fa._flash_fwd_cuda(q, k, v, q_offset)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, q_offset)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta_ref, q_offset)
    torch.cuda.synchronize()

    kd = fa.kernel_head_dim(d, getattr(torch, dtype))
    tag = (" f32" if dtype == "float32" else "") + (" d256" if kd == 256
                                                     else "")
    if dtype == "bfloat16":
        out = grad = (tile_rel_err, BF16_TILE_REL_TOL)
        stat_tol = F32_STAT_TOL
    else:
        out, grad = (abs_err, F32_OUT_TOL), (abs_err, F32_GRAD_TOL)
        stat_tol = F32_KERNEL_STAT_TOL

    def reading(measure, got, want):
        return measure[0](got, want), measure[1]

    readings = {
        f"K1{tag} O": reading(out, o, o_ref),
        f"K1{tag} lse": (abs_err(lse, lse_ref), stat_tol),
        f"K2{tag} dq": reading(grad, dq, dq_ref),
        f"K2{tag} delta": (abs_err(delta, delta_ref), stat_tol),
        f"K3{tag} dk": reading(grad, dk, dk_ref),
        f"K3{tag} dv": reading(grad, dv, dv_ref),
    }
    if exact_f32:
        require(dtype == "float32", "the exact-f32 reading is for f32")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            o_tf, lse_tf = fa._flash_fwd_plain(q, k, v, bq, bk, q_offset)
            dq_tf = fa._flash_bwd_dq_plain(q, k, v, o_ref, lse_ref, do, bq,
                                           bk, q_offset)[0]
            dk_tf, dv_tf = fa._flash_bwd_dkv_plain(q, k, v, do, lse_ref,
                                                   delta_ref, bq, bk,
                                                   q_offset)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for name, got, tf, want in ((f"K1{tag} O", o, o_tf, o_ref),
                                    (f"K1{tag} lse", lse, lse_tf, lse_ref),
                                    (f"K2{tag} dq", dq, dq_tf, dq_ref),
                                    (f"K3{tag} dk", dk, dk_tf, dk_ref),
                                    (f"K3{tag} dv", dv, dv_tf, dv_ref)):
            readings[name + " exact"] = (
                abs_err(got, want), EXACT_F32_FRACTION * abs_err(tf, want))
    sfx = fa._launch_key(fa._KERNEL_DTYPES[q.dtype], kd)
    errs = {
        "flash_fwd" + sfx: abs_err(o, o_ref),
        "flash_bwd_dq" + sfx: abs_err(dq, dq_ref),
        "flash_bwd_dkv" + sfx: max(abs_err(dk, dk_ref), abs_err(dv, dv_ref)),
    }
    return readings, errs, (q, k, v, do, o_ref, lse_ref, delta_ref, bq, bk)


def check_kernels(device, b, sq, sk, h, d, q_offset, seed=0,
                  dtype="bfloat16", exact_f32=False):
    """:func:`kernel_errors`, printed, raising past any limit. Returns
    ({kernel: max abs err}, inputs)."""
    readings, errs, inputs = kernel_errors(device, b, sq, sk, h, d, q_offset,
                                           seed, dtype, exact_f32)
    shape = f"{dtype} B={b} Sq={sq} Sk={sk} H={h} D={d} q_offset={q_offset}"
    how = ("O/dq/dk/dv: tile norm rel err" if dtype == "bfloat16"
           else "O/dq/dk/dv: max abs err")
    bad = [f"{n} {r:.3g} > {lim:.3g}" for n, (r, lim) in readings.items()
           if not r <= lim]
    exact = {n: rl for n, rl in readings.items() if n.endswith(" exact")}
    print(f"[kernels] {shape}: " + " ".join(
        f"{n}={r:.3g}" for n, (r, _) in readings.items() if n not in exact)
        + f" ({how}; lse/delta: max abs err)"
        + ("; exact f32, kernel err vs one TF32 product's err: " + ", ".join(
            f"{n.split()[-2]} {r:.3g} vs {lim / EXACT_F32_FRACTION:.3g}"
            for n, (r, lim) in exact.items())
           + f" (limit {EXACT_F32_FRACTION:g}x)" if exact else "")
        + (f"  FAILED: {bad}" if bad else "  ok"))
    require(not bad, f"kernel vs plain at {shape}: {bad}")
    return errs, inputs


def profiled_kernels(fn):
    """Run ``fn`` once under ``torch.profiler``; the device kernels it
    launched (chrome trace events: ``name``, ``ts``, ``dur`` in
    microseconds) and the host's wall time around it in microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        if on_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if on_cuda:
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    return ([e for e in events if e.get("cat") == "kernel" and "dur" in e],
            wall_us)


def sdpa_backend(kernel_names):
    """Which ``scaled_dot_product_attention`` backend launched these
    device kernels; "not measured" when the profiler saw none."""
    if not kernel_names:
        return "not measured (no kernel in the profile)"
    names = " ".join(kernel_names).lower()
    # cuDNN's kernel names contain "flash" too: it is matched first.
    for backend, marks in (("cudnn", ("cudnn",)),
                           ("efficient", ("fmha", "efficient", "mem_eff")),
                           ("flash", ("flash",))):
        if any(m in names for m in marks):
            return backend
    return "math"


def phase_kernels(device, batch, seq, heads, head_dim, smi):
    """Phase 3: every kernel, bf16 and f32, against its plain version at
    small shapes and at the main path's; then each kernel's time there
    beside its plain version's, SDPA's on the same inputs and its bound.
    Returns {kernel: results}."""
    results = {}
    for dtype in ("bfloat16", "float32"):
        for shape in [(2, 96, 160, 3, 32, 64), (1, 192, 320, 4, 64, 128),
                      (2, 128, 128, 2, 16, 0), (1, 200, 200, 2, 128, 0),
                      (1, 256, 512, 4, 128, 256), (1, 136, 328, 3, 128, 150),
                      (2, 64, 64, 2, 128, 0), (1, 72, 200, 3, 128, 128),
                      (1, 100, 90, 2, 64, 20),
                      # D = 80 runs zero-padded on the D = 128 kernels.
                      (1, 200, 200, 2, 80, 0), (2, 96, 160, 3, 80, 64),
                      # B*H = 65536 blocks on the grid's x dimension.
                      (4096, 64, 64, 16, 64, 0)]:
            check_kernels(device, *shape, seed=1, dtype=dtype)
        results.update(time_kernels(device, batch, seq, heads, head_dim,
                                    dtype, smi))
    return results


def time_kernels(device, b, s, h, d, dtype, smi):
    """The kernels of ``dtype`` at the main path's shape: checked, then
    timed with CUDA events beside their plain versions and SDPA."""
    import torch
    import torch.nn.functional as F

    from rayfed_tpu_torch.ops import flash_attention as fa

    sfx = fa._launch_key(fa._KERNEL_DTYPES[getattr(torch, dtype)],
                         fa.kernel_head_dim(d, getattr(torch, dtype)))
    errs, (q, k, v, do, o, lse, delta, bq, bk) = check_kernels(
        device, b, s, s, h, d, 0, dtype=dtype,
        exact_f32=dtype == "float32")
    iters = 10
    ms = {
        "flash_fwd": cuda_ms(lambda: fa._flash_fwd_cuda(q, k, v, 0), iters),
        "flash_bwd_dq": cuda_ms(
            lambda: fa._flash_bwd_dq_cuda(q, k, v, o, lse, do, 0), iters),
        "flash_bwd_dkv": cuda_ms(
            lambda: fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, 0), iters),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(
            lambda: fa._flash_fwd_plain(q, k, v, bq, bk, 0), 3, 1),
        "flash_bwd_dq": cuda_ms(
            lambda: fa._flash_bwd_dq_plain(q, k, v, o, lse, do, bq, bk, 0), 3, 1),
        "flash_bwd_dkv": cuda_ms(
            lambda: fa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, bq, bk, 0),
            3, 1),
    }
    # Yardstick: one PyTorch call for the same function. The forward for
    # K1; the whole backward (dq, dk, dv at once) for K2 and K3.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    sdpa_fwd = cuda_ms(sdpa, iters)
    out = sdpa()
    dot = do.transpose(1, 2)

    def sdpa_grad():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    sdpa_bwd = cuda_ms(sdpa_grad, iters)
    names = sorted({e["name"] for fn in (sdpa, sdpa_grad)
                    for e in profiled_kernels(fn)[0]})
    print(f"[kernels] {dtype} sdpa backend {sdpa_backend(names)}: "
          f"{names[:6]}")
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkv": sdpa_bwd}

    work = kernel_work(b, s, s, h, d, 0, elem=2 if dtype == "bfloat16" else 4)
    results = {}
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        flops, nbytes = work[n]
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        results[n + sfx] = dict(
            max_abs_err=errs[n + sfx], ms=ms[n], plain_ms=plain_ms[n],
            library_ms=library_ms[n], bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] {n + sfx} {dtype} B={b} S={s} H={h} D={d}: "
              f"{ms[n]:.3f} ms (plain {plain_ms[n]:.3f}, sdpa "
              f"{library_ms[n]:.3f}); {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e6:.1f} MB; bound {bound_ms:.3f} ms by {bound_by} "
              f"({100 * bound_ms / ms[n]:.1f}% of roofline, "
              f"{flops / ms[n] / 1e9:.1f} TFLOP/s) on {smi}")
    return results


# ---------------------------------------------------------------------------
# Phase 4: the federated round loop
# ---------------------------------------------------------------------------


def _trees_equal(a, b):
    import torch

    from rayfed_tpu_torch import tree_util

    la, sa = tree_util.tree_flatten(a)
    lb, sb = tree_util.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def fedavg_rounds(cfg, device, *, batch, seq, rounds, local_steps, lr,
                  init=0):
    """Two-party FedAvg (``PARTIES``) with flash attention: each round
    every party takes ``local_steps`` AdamW steps on its own data from the
    shared params, ``tree_mean`` folds the parties' params, and each party
    loads the aggregate in place (its optimizer moments carry on, as in
    ``examples/federated_transformer.py``). ``init`` is a seed or a numpy
    params tree. Returns the per-party losses, the aggregate's eval loss
    before and after each round, whether each round started from
    bitwise-identical trees, the step times, the kernel launches of the
    evaluations (the rest of the run's launches are the train steps') and
    the final aggregate."""
    import numpy as np
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    on_cuda = torch.device(device).type == "cuda"
    init_fn, step_fn = make_fed_train_step(cfg, device, lr=lr, attn="flash")
    data = {name: synthetic_lm_dataset(cfg.vocab, batch * local_steps * (seq + 1),
                                       seq, seed=seed)
            for name, seed in PARTIES}
    state = {name: init_fn(init) for name in data}
    # One window from each party's data: the aggregate's eval block.
    eval_blk = torch.as_tensor(np.stack(
        [next(data[name].batches(batch, epoch=0))[0] for name in data]),
        device=device).long()
    eval_attn = fa.make_flash_attn_fn()
    eval_launches = dict.fromkeys(fa.LAUNCHES, 0)

    def eval_loss(params):
        before = dict(fa.LAUNCHES)
        with torch.no_grad():
            loss = float(tfm.lm_loss_pair(
                params, eval_blk[:, :-1], eval_blk[:, 1:], cfg, eval_attn,
                loss_chunk=512))
        for k in eval_launches:
            eval_launches[k] += fa.LAUNCHES[k] - before[k]
        return loss

    names = list(data)
    out = {"losses": {n: [] for n in names}, "step_ms": [],
           "starts_identical": [], "eval": [], "eval_launches": eval_launches}
    out["eval"].append(eval_loss(state[names[0]][0]))
    for r in range(rounds):
        first = state[names[0]][0]
        out["starts_identical"].append(
            all(_trees_equal(first, state[n][0]) for n in names[1:]))
        for name in names:
            params, opt = state[name]
            for blk in data[name].batches(batch, epoch=r):
                t0 = time.perf_counter()
                params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
                if on_cuda:
                    torch.cuda.synchronize()
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out["losses"][name].append(float(loss))
            state[name] = (params, opt)
        with torch.no_grad():
            agg = tree_mean(*[state[n][0] for n in names])
            for name in names:
                for p, a in zip(tree_util.tree_flatten(state[name][0])[0],
                                tree_util.tree_flatten(agg)[0]):
                    p.copy_(a)
        out["eval"].append(eval_loss(state[names[0]][0]))
    out["aggregate"] = state[names[0]][0]
    out["eval_block"] = eval_blk
    blk = next(data[names[0]].batches(batch, epoch=rounds))
    out["profile_step"] = lambda: step_fn(*state[names[0]], blk[:, :-1],
                                          blk[:, 1:])
    return out


def device_breakdown(fn):
    """Run ``fn`` once under ``torch.profiler`` and split the device time
    of the kernels it launched: flash kernels, matrix products (cuBLAS /
    CUTLASS names), everything else; plus the device's busy share of the
    host's wall time around the call. Returns None when the profiler
    recorded no device kernel (a CPU run)."""
    kernels, wall_us = profiled_kernels(fn)
    return kernel_split(kernels, wall_us) if kernels else None


def kernel_split(kernels, wall_us):
    """Device ms by kind and the idle share of ``wall_us``, from chrome
    trace kernel events (``name``, ``ts`` and ``dur`` in microseconds);
    overlapping kernels count once toward busy time."""
    split = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e["name"].lower()
        if "flash_" in name and "_kernel" in name:
            split["flash"] += e["dur"]
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
            split["matmul"] += e["dur"]
        else:
            split["other"] += e["dur"]
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return dict({k: v / 1e3 for k, v in split.items()},
                busy_ms=busy / 1e3, wall_ms=wall_us / 1e3,
                idle_share=1.0 - busy / wall_us, n_kernels=len(kernels))


def phase_slice(device, cfg, *, batch, seq, rounds=3, local_steps=2,
                lr=1e-3, label=""):
    """Phase 4: run :func:`fedavg_rounds` and check it; returns a summary
    with the kernel launches counted during the run, the train steps'
    (``launches``) apart from the evaluations' (``eval_launches``)."""
    import torch

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa

    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    run = fedavg_rounds(cfg, device, batch=batch, seq=seq, rounds=rounds,
                        local_steps=local_steps, lr=lr)
    wall = time.perf_counter() - t0
    eval_launches = run["eval_launches"]
    launches = {k: n - eval_launches[k] for k, n in fa.LAUNCHES.items()}

    require(all(run["starts_identical"]),
            f"parties started a round from different trees: "
            f"{run['starts_identical']}")
    flat = [x for v in run["losses"].values() for x in v] + run["eval"]
    require(all(x == x and abs(x) < 1e30 for x in flat),
            f"non-finite loss: {run['losses']} {run['eval']}")
    require(run["eval"][-1] < run["eval"][0],
            f"aggregate loss did not fall: {run['eval']}")
    # Flash and dense attention agree on the final aggregate's loss.
    blk = run["eval_block"]
    with torch.no_grad():
        dense = float(tfm.lm_loss_pair(run["aggregate"], blk[:, :-1],
                                       blk[:, 1:], cfg, None, loss_chunk=512))
    require(abs(dense - run["eval"][-1]) <= ATTN_LOSS_TOL,
            f"flash loss {run['eval'][-1]} vs dense {dense}")
    # One more local step of the first party, profiled after the checks
    # (it updates the aggregate's tensors in place) and the launch count.
    breakdown = device_breakdown(run["profile_step"])

    # The window: every step after the first (which warms the allocator
    # and the kernels' first launches up).
    steps = run["step_ms"][1:] or run["step_ms"]
    step_ms = statistics.median(steps)
    summary = dict(
        wall_s=wall, step_ms=step_ms,
        tokens_per_s=len(steps) * batch * seq / sum(steps) * 1e3,
        eval=run["eval"], dense_eval=dense, losses=run["losses"],
        launches=launches, eval_launches=eval_launches, breakdown=breakdown,
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if on_cuda else None),
    )
    print(f"[slice] {label} eval loss per round {run['eval']} "
          f"(dense attention {dense:.5f})")
    print(f"[slice] {label} losses {run['losses']}")
    print(f"[slice] {label} {len(steps)} steps in {sum(steps):.1f} ms, "
          f"{summary['tokens_per_s']:.1f} tokens/s (step median "
          f"{step_ms:.1f} ms), max_memory_allocated "
          f"{summary['max_memory_allocated']}, wall {wall:.1f}s")
    print(f"[slice] {label} launches: train steps {launches}, "
          f"evaluations {eval_launches}")
    print_breakdown("[slice]", label, breakdown)
    return summary


def print_breakdown(tag, label, breakdown):
    """Print :func:`device_breakdown`'s split of one profiled step."""
    if breakdown is None:
        print(f"{tag} {label} device breakdown: not measured (no device "
              "kernels in the profile)")
    else:
        print(f"{tag} {label} one profiled step, device ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items()
                          if k not in ("idle_share", "n_kernels"))
              + f"; idle share {breakdown['idle_share']:.3f}, "
              f"{breakdown['n_kernels']} kernels")


# ---------------------------------------------------------------------------
# Phase 4b: the f32 model through the f32 kernels
# ---------------------------------------------------------------------------

F32_STEPS = 4  # timed, after one that warms the allocator and kernels up


def phase_f32(device, cfg, *, batch, seq, steps=F32_STEPS, lr=1e-3,
              label=""):
    """Phase 4b: ``cfg`` in f32 (``compute_dtype=torch.float32``) through
    ``make_fed_train_step(attn="auto")``, which takes the f32 flash
    kernels on a card: ``steps`` + 1 AdamW steps at ``batch``, then one
    batch-1 step's loss and gradients (the train step's loss function,
    ``lm_loss_pair``) with the flash kernels against the same with the
    dense attention (``attn="xla"``). One more step at ``batch``, after
    the launches are taken, is profiled by :func:`device_breakdown`.
    Returns a summary with the kernel launches of the steps."""
    import dataclasses
    import gc

    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    on_cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    data = synthetic_lm_dataset(cfg.vocab, batch * (steps + 1) * (seq + 1),
                                seq, seed=PARTIES[0][1])
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    init_fn, step_fn = make_fed_train_step(cfg, device, lr=lr, attn="auto")
    params, opt = init_fn(0)
    step_ms, losses = [], []
    for blk in data.batches(batch, epoch=0):
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        if on_cuda:
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    require(len(losses) == steps + 1 and
            all(x == x and abs(x) < 1e30 for x in losses),
            f"f32 steps: losses {losses}")
    # One more step, profiled: how the step's device time divides.
    breakdown = device_breakdown(
        lambda: step_fn(params, opt, blk[:, :-1], blk[:, 1:]))
    del params, opt
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # Batch 1: one step's loss and gradients, flash kernels vs dense.
    params = tree_util.tree_map(lambda p: p.requires_grad_(True),
                                tfm.init_params(0, cfg, device))
    leaves = tree_util.tree_flatten(params)[0]
    blk = torch.as_tensor(next(data.batches(1, epoch=1)), device=device).long()
    got = {}
    for attn, attn_fn in (("flash", fa.make_flash_attn_fn()), ("xla", None)):
        loss = tfm.lm_loss_pair(params, blk[:, :-1], blk[:, 1:], cfg, attn_fn,
                                loss_chunk=512)
        got[attn] = (float(loss.detach()),
                     torch.autograd.grad(loss, leaves))
    loss_rel = abs(got["flash"][0] - got["xla"][0]) / abs(got["xla"][0])
    grad_rel = max(
        float(torch.linalg.vector_norm(g - w)
              / torch.linalg.vector_norm(w).clamp(min=1e-30))
        for g, w in zip(got["flash"][1], got["xla"][1]))
    timed = step_ms[1:]
    summary = dict(
        step_ms=statistics.median(timed),
        tokens_per_s=len(timed) * batch * seq / sum(timed) * 1e3,
        losses=losses, launches=launches, max_memory_allocated=peak,
        loss_rel=loss_rel, grad_rel=grad_rel, breakdown=breakdown)
    print(f"[f32] {label} {len(timed)} steps after the first: step median "
          f"{summary['step_ms']:.1f} ms, {summary['tokens_per_s']:.1f} "
          f"tokens/s, max_memory_allocated {peak}; losses {losses}")
    print(f"[f32] {label} launches {launches}")
    print_breakdown("[f32]", label, breakdown)
    print(f"[f32] {label} batch 1, flash vs attn='xla': loss "
          f"{got['flash'][0]:.6f} vs {got['xla'][0]:.6f} (rel {loss_rel:.3g} "
          f"<= {F32_LOSS_RTOL}), largest gradient leaf rel err "
          f"{grad_rel:.3g} (<= {F32_GRAD_RTOL})")
    require(loss_rel <= F32_LOSS_RTOL,
            f"f32 loss with flash vs dense: rel {loss_rel}")
    require(grad_rel <= F32_GRAD_RTOL,
            f"f32 gradients with flash vs dense: rel {grad_rel}")
    return summary


# ---------------------------------------------------------------------------
# Phase 5: the same round through the port's engine, two processes
# ---------------------------------------------------------------------------

FED_ROUNDS = 2
# Each party job's join deadline: at most three times its phase's wall
# and never above 240 s. Phases 5, 6 and 12 (d) share this one: walls
# 58.2, 52.9 and 86.8 s in a whole run on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 5), as are the walls below.
FED_JOIN_TIMEOUT_S = 150
# Retry fast while the peer comes up; no payload cap (a params push is
# 1.36 GB at the flagship width, past the 500 MB default).
FED_COMM = {"retry_policy": {"max_attempts": 30, "initial_backoff_ms": 100,
                             "max_backoff_ms": 1000},
            "messages_max_size_in_bytes": 0}


#: Bytes of one piece of a leaf that :func:`_tree_digest` hashes on its
#: own thread: the embedding and the LM head are two thirds of a
#: flagship tree's bytes, and hashed whole they would take two threads.
DIGEST_PIECE = 64 << 20


def _tree_digest(tree):
    """sha256 of each tensor leaf's bytes (bf16 through its int16 view):
    of a leaf over ``DIGEST_PIECE`` bytes, the sha256 of its pieces'
    sha256s. The pieces are copied to host (from a card) and hashed on
    threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rayfed_tpu_torch import tree_util

    leaves = tree_util.tree_flatten(tree)[0]
    if any(x.is_cuda for x in leaves):
        # The pool's copies run on its threads' streams: finish the work
        # queued on this thread's first.
        torch.cuda.synchronize()
    pieces = []
    for x in leaves:
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        flat = x.contiguous().reshape(-1)
        per = max(1, DIGEST_PIECE // flat.element_size())
        pieces.append([flat[i:i + per]
                       for i in range(0, max(flat.numel(), 1), per)])

    def one(piece):
        return hashlib.sha256(piece.cpu().numpy().data).digest()

    with ThreadPoolExecutor(8) as pool:
        done = iter(pool.map(one, [p for ps in pieces for p in ps]))
        out = []
        for ps in pieces:
            got = [next(done) for _ in ps]
            out.append(got[0].hex() if len(got) == 1
                       else hashlib.sha256(b"".join(got)).hexdigest())
        return out


def _tree_nbytes(tree):
    from rayfed_tpu_torch import tree_util

    return sum(x.nbytes for x in tree_util.tree_flatten(tree)[0])


def _last_span(kind, min_bytes):
    """This process's latest tracing span of ``kind`` moving at least
    ``min_bytes``: the one of the push just made or received."""
    from rayfed_tpu_torch import tracing

    spans = [sp for sp in tracing.get_spans(kind) if sp.nbytes >= min_bytes]
    return spans[-1] if spans else None


def _span_ms(sp):
    return None if sp is None else 1e3 * sp.duration_s


def _arrive(tree, device, t_sent=None, kind="decode"):
    """The receiving end of a push: the tree's leaves on ``device`` and
    what the push took. ``push_ms`` runs from ``t_sent`` (the owner's wall
    clock when its value resolved) to the leaves on the device: until the
    frame finished decoding (its ``decode`` span; ``kind`` "pull": the
    device-DMA lane's pull, whose leaves land on the card), plus the timed
    copy to the device. ``arrived_at`` is that end on the wall clock. Also
    the digest of the bytes that arrived and, for a pull, its engine."""
    import torch

    from rayfed_tpu_torch import tree_util

    nbytes = _tree_nbytes(tree)
    dec = _last_span(kind, nbytes)
    leaves, spec = tree_util.tree_flatten(tree)
    t = time.perf_counter()
    on_dev = [x.to(device) for x in leaves]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    h2d_ms = 1e3 * (time.perf_counter() - t)
    push_ms = arrived_at = None
    if dec is not None:
        arrived_at = dec.start_s + dec.duration_s + time.time() \
            - time.perf_counter() + h2d_ms / 1e3
        if t_sent is not None:
            push_ms = 1e3 * (arrived_at - t_sent)
    info = dict(nbytes=nbytes, push_ms=push_ms, h2d_ms=h2d_ms,
                arrived_at=arrived_at, digest=_tree_digest(tree),
                **{f"{kind}_ms": _span_ms(dec)})
    if kind == "pull":
        extra = {} if dec is None else dec.extra
        info["engine"] = extra.get("engine")
        # The pull's request, and an IPC pull's alloc, open, copy, close.
        info["pull_parts"] = {k[:-3]: v for k, v in extra.items()
                              if k.endswith("_ms")}
    return tree_util.tree_unflatten(on_dev, spec), info


def _sender_spans(nbytes):
    """This process's capture (``stage``: host staging, or the device-DMA
    lane's snapshot on the card) and socket send (``send``: of the frame
    carrying that push, a descriptor on the DMA lane) ms of its latest push
    of ``nbytes`` or more, and the capture's start on the wall clock."""
    from rayfed_tpu_torch import tracing

    stage = _last_span("stage", nbytes)
    if stage is None:
        return dict(stage_ms=None, send_ms=None, stage_start=None)
    key = (stage.upstream_seq_id, stage.downstream_seq_id)
    sends = [sp for sp in tracing.get_spans("send")
             if (str(sp.upstream_seq_id), str(sp.downstream_seq_id)) == key]
    return dict(stage_ms=_span_ms(stage),
                send_ms=_span_ms(sends[-1] if sends else None),
                stage_start=stage.start_s + time.time() - time.perf_counter())


def _idle_lane_stats(timeout_s=30.0):
    """This process's device-DMA lane stats once it holds no snapshot (a
    sender frees one when its receiver says it is done), or at the
    timeout."""
    from rayfed_tpu_torch.proxy.cuda import dma

    deadline = time.monotonic() + timeout_s
    while True:
        st = dma.stats()
        if (st["device_snapshots"] == 0 and st["parked"] == 0) \
                or time.monotonic() > deadline:
            return st
        time.sleep(0.02)


def _fed_program(party, addresses, device, cfg_kw, batch, seq, rounds,
                 local_steps, lr, dma=False):
    """Phase 5's driver: the same program runs in every party. Returns
    what the parent checks and prints; every value in it reached this
    party through ``fed.get``, so both parties return the same. With
    ``dma`` (phase 11) the parties run ``transport="cuda"`` with
    ``device_dma``: the pushed values are the bare param trees (the
    device-DMA lane takes a tree whose every leaf is on the card), the
    receiver's ``pull`` span and engine are recorded, and the root holds
    each aggregate against the CPU fold of the two trees."""
    import numpy as np
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.proxy.tcp import sockio

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    seeds = dict(PARTIES)
    names = [n for n, _ in PARTIES]
    root, other = names

    def party_data(name):
        return synthetic_lm_dataset(cfg.vocab, batch * local_steps * (seq + 1),
                                    seq, seed=seeds[name])

    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if dma else "tcp",
             config={"cross_silo_comm": dict(FED_COMM, device_dma=True)
                     if dma else FED_COMM})
    kind = "pull" if dma else "decode"

    def wrap(tree):
        """A pushed tree: with the owner's clock on the TCP lane."""
        return tree if dma else {"params": tree, "t": time.time()}

    def unwrap(value):
        return (value, None) if dma else (value["params"], value["t"])

    @fed.remote
    class LocalTrainer:
        """One party's params and AdamW state on its device."""

        def __init__(self, name):
            self.name = name
            init_fn, self.step_fn = make_fed_train_step(
                cfg, device, lr=lr, attn="flash")
            self.params, self.opt = init_fn(0)
            self.data = party_data(name)
            self.losses = []
            self.eval_launches = dict.fromkeys(fa.LAUNCHES, 0)
            self.sent = None

        def _step(self, blk):
            self.params, self.opt, loss = self.step_fn(
                self.params, self.opt, blk[:, :-1], blk[:, 1:])
            self.losses.append(float(loss))

        def digest(self):
            return _tree_digest(self.params)

        def train(self, r):
            for blk in self.data.batches(batch, epoch=r):
                self._step(blk)
            # The owner's digest of what it pushes, then the push.
            self.sent = _tree_digest(self.params)
            return wrap(self.params)

        def step_after_push(self, r):
            # The next opt.step() rewrites the pushed tensors in place
            # while the push may still be in flight.
            self._step(next(self.data.batches(batch, epoch=rounds + r)))
            return self.losses[-1]

        def sent_digest(self):
            return self.sent

        def load(self, agg):
            info = None
            params, t_sent = unwrap(agg)
            if self.name != root:
                params, info = _arrive(params, device, t_sent, kind)
            with torch.no_grad():
                for p, a in zip(tree_util.tree_flatten(self.params)[0],
                                tree_util.tree_flatten(params)[0]):
                    p.copy_(a)
            return info

        def bf16_params(self):
            tree = tree_util.tree_map(lambda x: x.to(torch.bfloat16),
                                      self.params)
            self.sent = _tree_digest(tree)
            return tree

        def eval_loss(self):
            blk = torch.as_tensor(np.stack(
                [next(party_data(n).batches(batch, epoch=0))[0]
                 for n in names]), device=device).long()
            before = dict(fa.LAUNCHES)
            with torch.no_grad():
                loss = float(tfm.lm_loss_pair(
                    self.params, blk[:, :-1], blk[:, 1:], cfg,
                    fa.make_flash_attn_fn(), loss_chunk=512))
            for k in self.eval_launches:
                self.eval_launches[k] += fa.LAUNCHES[k] - before[k]
            return loss

        def report(self):
            return dict(
                launches={k: n - self.eval_launches[k]
                          for k, n in fa.LAUNCHES.items()},
                eval_launches=self.eval_launches,
                max_memory_allocated=(torch.cuda.max_memory_allocated()
                                      if on_cuda else None),
                io_path=sockio.io_path(),
            )

    @fed.remote
    def aggregate(mine, theirs):
        tree, t_sent = unwrap(theirs)
        params, info = _arrive(tree, device, t_sent, kind)
        mine = unwrap(mine)[0]
        with torch.no_grad():
            agg = tree_mean(mine, params)
        if dma:
            # As phase 6 (b): the fold on the card against the CPU's.
            host = [tree_util.tree_map(lambda x: x.cpu(), t)
                    for t in (mine, params, agg)]
            want = tree_mean(host[0], host[1])
            info["fold_mismatched"] = sum(
                int((_int_view(a) != _int_view(b)).sum()) for a, b in zip(
                    tree_util.tree_flatten(host[2])[0],
                    tree_util.tree_flatten(want)[0]))
            del host, want
        # The owner's digest of what it pushes, then the push.
        info["owner_digest_next"] = _tree_digest(agg)
        return wrap(agg), info

    @fed.remote
    def sender_spans(nbytes):
        return _sender_spans(nbytes)

    @fed.remote
    def received_digest(tree):
        return _arrive(tree, device)[1]["digest"]

    @fed.remote
    def lane_stats():
        return _idle_lane_stats()

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    trainers = {n: LocalTrainer.party(n).remote(n) for n in names}
    evals = [fed.get(trainers[root].eval_loss.remote())]
    rounds_out = []
    for r in range(rounds):
        t0 = time.perf_counter()
        starts = fed.get([trainers[n].digest.remote() for n in names])
        pushed = {n: trainers[n].train.remote(r) for n in names}
        agg, agg_info = aggregate.party(root).options(num_returns=2).remote(
            pushed[root], pushed[other])
        # Submitted after the push is registered, so the push captures
        # the trained tree as it resolves; the step then rewrites those
        # tensors in place while the push is in flight.
        after = trainers[other].step_after_push.remote(r)
        sent = trainers[other].sent_digest.remote()
        fed.get(agg)
        loaded = [trainers[n].load.remote(agg) for n in names]
        sent, params_push, aggregate_push, _ = fed.get(
            [sent, agg_info, loaded[1], after])
        spans = fed.get([sender_spans.party(n).remote(push["nbytes"])
                         for n, push in ((root, aggregate_push),
                                         (other, params_push))])
        params_push.update(spans[1], owner_digest=sent)
        aggregate_push.update(spans[0],
                              owner_digest=params_push.pop("owner_digest_next"))
        if dma:
            # From the owner's capture to the receiver's tensors on its card.
            for push in (params_push, aggregate_push):
                push["push_ms"] = 1e3 * (push["arrived_at"]
                                         - push["stage_start"])
        evals.append(fed.get(trainers[root].eval_loss.remote()))
        rounds_out.append(dict(
            wall_s=time.perf_counter() - t0,
            starts_identical=all(d == starts[0] for d in starts[1:]),
            params_push=params_push, aggregate_push=aggregate_push))
    bf = trainers[other].bf16_params.remote()
    bf16 = fed.get([trainers[other].sent_digest.remote(),
                    received_digest.party(root).remote(bf)])
    reports = fed.get([trainers[n].report.remote() for n in names])
    lane_states = fed.get([lane_stats.party(n).remote() for n in names]) \
        if dma else None
    fed.shutdown()
    return dict(party=party, evals=evals, rounds=rounds_out,
                bf16_digests=bf16, reports=dict(zip(names, reports)),
                lanes=lane_states and dict(zip(names, lane_states)))


def _fed_program_python_io(party, addresses, *args):
    """:func:`_fed_program` with this party's wire on sockio's Python IO
    path: the port's references to its native module are taken away
    before ``fed.init`` (the comparison run of phase 5)."""
    from rayfed_tpu_torch.proxy import lanes
    from rayfed_tpu_torch.proxy.tcp import checksum, sockio

    sockio._fastwire = checksum._fw = lanes._fw = None
    return _fed_program(party, addresses, *args)


def fed_party(program, party, addresses, out_path, t_spawn, *args):
    """A party process of the multi-process phases (spawned): runs
    ``program(party, addresses, *args)`` and writes its result, or the
    error, as JSON to ``out_path``, with its setup seconds apart from its
    work (``setup``): from ``t_spawn`` (the parent's ``time.time()`` at
    the spawn) to this function, the imports, the card's context and
    the models' initialization (``init_params``, synchronized); the
    program's ``fed.init`` and ``fed.shutdown`` are timed apart from the
    rest of its work."""
    import traceback

    setup = {"spawn": time.time() - t_spawn}
    try:
        t = time.perf_counter()
        import torch

        import rayfed_tpu_torch  # noqa: F401
        from rayfed_tpu_torch.models import transformer as tfm
        from rayfed_tpu_torch.parallel import train  # noqa: F401

        setup["import"] = time.perf_counter() - t
        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        setup["context"] = time.perf_counter() - t
        setup["model init"] = 0.0
        init_params = tfm.init_params

        def timed_init(*a, **kw):
            t = time.perf_counter()
            out = init_params(*a, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            setup["model init"] += time.perf_counter() - t
            return out

        tfm.init_params = timed_init
        import rayfed_tpu_torch as fed

        for name in ("init", "shutdown"):
            setup[f"fed.{name}"] = 0.0
            setattr(fed, name, _timed(getattr(fed, name), setup,
                                      f"fed.{name}"))
        t = time.perf_counter()
        result = dict(ok=True, **program(party, addresses, *args))
        setup["work"] = (time.perf_counter() - t - setup["model init"]
                         - setup["fed.init"] - setup["fed.shutdown"])
        result["setup"] = setup
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = dict(ok=False, error=traceback.format_exc())
        print(f"party {party} failed:\n{result['error']}", file=sys.stderr,
              flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f)
    sys.exit(0 if result["ok"] else 1)


def _timed(fn, into, key):
    """``fn`` adding its seconds to ``into[key]``."""
    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            into[key] += time.perf_counter() - t

    return timed


def _free_port():
    """A localhost port for a party's listener or a store, held back from
    the kernel's own picks until its owner binds it. A port that is only
    found free and closed can be handed out again as the local port of
    any later connection or ``bind(0)`` (a gloo pair, a store client)
    before the party process binds it, which then fails with EADDRINUSE.
    So the port is left in TIME_WAIT (one accepted connection, closed
    from the server's side): for the next 60 s the kernel gives it to no
    connect or ``bind(0)``, while a listener that sets SO_REUSEADDR, as
    the port's proxies and ``TCPStore`` do, binds it at once."""
    import socket

    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        name = s.getsockname()
        with socket.socket() as c:
            c.connect(name)
            conn, _ = s.accept()
            conn.close()
        return name[1]


def phase_fed(device, cfg, *, batch, seq, rounds=FED_ROUNDS, local_steps=2,
              lr=1e-3, label="", timeout_s=FED_JOIN_TIMEOUT_S,
              io_path="native"):
    """Phase 5: :func:`fedavg_rounds`'s FedAvg round driven through the
    port's own engine, one spawned process per party over localhost TCP,
    and checked: (a) every tree that crossed arrived bitwise as its
    owner hashed it, (b) every round started from identical params, (c)
    the receiver got the pre-step bytes although the owner stepped in
    place right after its push, (d) the aggregate's loss fell, (e) each
    party's train steps launched every bf16 kernel, (f) a bf16 tree
    crossed bitwise, (g) both parties ran ``io_path`` ("native", or
    "python" for the comparison run, whose parties drop the native
    module). Returns both parties' results."""
    import dataclasses

    import torch

    if torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info()
        print(f"[fed] {label} at the spawn: {free} of {total} bytes free")
    program = _fed_program if io_path == "native" else _fed_program_python_io
    results, wall = spawn_parties(
        program, (device, dataclasses.asdict(cfg), batch, seq, rounds,
                  local_steps, lr), timeout_s)
    return check_fed(results, device, wall, label, io_path)


#: What every party process imports: the forkserver that forks them
#: imports it once (``party_context``), so a party process starts with it
#: loaded instead of importing torch anew (about 10 s a process on the
#: host of an H100 machine, PERF.md section 5).
PARTY_PRELOAD = ["numpy", "torch", "rayfed_tpu_torch",
                 "rayfed_tpu_torch.models.transformer",
                 "rayfed_tpu_torch.parallel.train"]


def party_context():
    """The multiprocessing context of the party processes: a forkserver
    (a fresh process, started once, that never touches the card) with
    ``PARTY_PRELOAD`` imported; each party process is forked from it and
    makes its own CUDA context."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PARTY_PRELOAD)
    return ctx


def start_party_server():
    """Start the party processes' forkserver on a thread, so its imports
    overlap the run's first phases."""
    import threading
    from multiprocessing import forkserver

    party_context()
    threading.Thread(target=forkserver.ensure_running,
                     name="party-forkserver", daemon=True).start()


def spawn_parties(program, args, timeout_s, names=None, processes=None):
    """Run ``program(party, addresses, *args)`` in one spawned process per
    party (``names``, by default ``PARTIES``') over localhost TCP; returns
    each party's result and the wall time from spawn to exit, and prints
    each process's setup seconds (spawn, import, card context, model
    init) apart from its work. ``processes`` maps a party to a list of
    extra arguments, one process each, appended after ``args`` (a party
    over several processes; its results are a list). Fails on a party's
    error, a missing result or the join deadline ``timeout_s`` (every
    process is stopped first)."""
    mp = party_context()
    names = names or [n for n, _ in PARTIES]
    addresses = {n: f"127.0.0.1:{_free_port()}" for n in names}
    processes = processes or {}
    runs = [(n, i, tuple(extra)) for n in names
            for i, extra in enumerate(processes.get(n, [()]))]
    with tempfile.TemporaryDirectory() as tmp:
        outs = {(n, i): os.path.join(tmp, f"{n}-{i}.json") for n, i, _ in runs}
        t_spawn = time.time()
        procs = {(n, i): mp.Process(
            target=fed_party, name=f"party-{n}-{i}", args=(
                program, n, addresses, outs[n, i], t_spawn) + tuple(args)
            + extra) for n, i, extra in runs}
        t0 = time.perf_counter()
        for p in procs.values():
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        late = [p.name for p in procs.values() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        require(not late, f"{program.__name__}: party processes {late} did "
                          f"not finish within their deadline of {timeout_s} s")
        results = {}
        for (n, i), p in procs.items():
            require(os.path.exists(outs[n, i]),
                    f"{p.name} exited with code {p.exitcode} and no result")
            with open(outs[n, i]) as f:
                res = json.load(f)
            require(res["ok"] and p.exitcode == 0,
                    f"{p.name} failed (exit code {p.exitcode}):\n"
                    f"{res.get('error')}")
            if n in processes:
                results.setdefault(n, []).append(res)
            else:
                results[n] = res
    setups = ", ".join(
        f"{p.name} " + " ".join(f"{k} {v:.1f}" for k, v in
                                (res["setup"].items()))
        for (n, i), p in procs.items()
        for res in [results[n][i] if n in processes else results[n]])
    print(f"[setup] {program.__name__} in {wall:.1f} s (deadline "
          f"{timeout_s} s), seconds a process: {setups}")
    return results, wall


def check_fed(results, device, wall, label="", io_path="native", dma=False):
    """Phase 5's checks (a)-(g) over both parties' results, and its
    report: per round the wall time and each push's ms, GB/s and split
    (with ``dma``, phase 11's: the snapshot, the descriptor's send and the
    pull, beside the bound of two device copies)."""
    import torch

    root, other = (n for n, _ in PARTIES)
    res = results[root]
    require(all(results[other][k] == res[k]
                for k in ("evals", "bf16_digests", "reports")),
            "the parties disagree on values both fetched through fed.get")
    for r, rnd in enumerate(res["rounds"]):
        require(rnd["starts_identical"],
                f"(b) round {r} started from different params")
        for push in ("params_push", "aggregate_push"):
            require(rnd[push]["digest"] == rnd[push]["owner_digest"],
                    f"(a)/(c) round {r}: the {push} arrived with other bytes "
                    f"than its owner pushed")
    require(res["evals"][-1] < res["evals"][0],
            f"(d) the aggregate's loss did not fall: {res['evals']}")
    bf_sent, bf_got = res["bf16_digests"]
    require(bf_sent == bf_got, "(f) the bf16 tree did not cross bitwise")
    if torch.device(device).type == "cuda":
        for n, rep in res["reports"].items():
            require(all(rep["launches"][k] > 0 for k in BF16_KERNELS),
                    f"(e) party {n}'s train steps did not launch every "
                    f"kernel: {rep['launches']}")
    paths = {n: rep["io_path"] for n, rep in res["reports"].items()}
    require(set(paths.values()) == {io_path},
            f"(g) the parties ran IO paths {paths}, not {io_path!r}")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    tag = "[dma]" if dma else "[fed]"
    print(f"{tag} {label} two party processes, {len(res['rounds'])} rounds "
          f"in {wall:.1f} s from spawn to exit; IO path {paths}")
    print(f"{tag} {label} aggregate eval loss per round {res['evals']}")
    for r, rnd in enumerate(res["rounds"]):
        parts = [f"round {r}: wall {rnd['wall_s']:.2f} s"]
        for push in ("params_push", "aggregate_push"):
            got = rnd[push]
            total = got["push_ms"]
            rate = ("" if total is None else
                    f", {got['nbytes'] / total / 1e6:.3f} GB/s")
            share = ("" if total is None or got["stage_ms"] is None else
                     f" ({100 * got['stage_ms'] / total:.1f}%)")
            if dma:
                parts.append(
                    f"{push} {got['nbytes']} B by {got['engine']}: "
                    f"{ms(total)}{rate}; snapshot on the card "
                    f"{ms(got['stage_ms'])}{share}, descriptor send "
                    f"{ms(got['send_ms'])}, pull {ms(got['pull_ms'])} "
                    f"({_fmt_parts(got['pull_parts'])}); bound "
                    f"{dma_bound_ms(got['nbytes']):.2f} ms")
                continue
            parts.append(
                f"{push} {got['nbytes']} B: {ms(total)}{rate}; host staging "
                f"{ms(got['stage_ms'])}{share}, send {ms(got['send_ms'])}, "
                f"decode {ms(got['decode_ms'])}, to the card "
                f"{ms(got['h2d_ms'])}")
        print(f"{tag} {label} " + "; ".join(parts))
    for n, rep in res["reports"].items():
        print(f"{tag} {label} party {n}: train launches {rep['launches']}, "
              f"evaluations {rep['eval_launches']}, max_memory_allocated "
              f"{rep['max_memory_allocated']}")
    return results


def compare_io_paths(runs):
    """Print phase 5's pushes of the native and the Python IO path's runs
    side by side: total, host staging, send and decode."""
    root = PARTIES[0][0]
    rows = {io: [(r, push, rnd[push]) for r, rnd in
                 enumerate(res[root]["rounds"])
                 for push in ("params_push", "aggregate_push")]
            for io, res in runs.items()}

    def ms(v):
        return "n/m" if v is None else f"{v:.1f}"

    for (r, push, nat), (_, _, py) in zip(rows["native"], rows["python"]):
        print(f"[fed] IO paths, round {r} {push} {nat['nbytes']} B, ms "
              f"native / python: total {ms(nat['push_ms'])} / "
              f"{ms(py['push_ms'])}, host staging {ms(nat['stage_ms'])} / "
              f"{ms(py['stage_ms'])}, send {ms(nat['send_ms'])} / "
              f"{ms(py['send_ms'])}, decode {ms(nat['decode_ms'])} / "
              f"{ms(py['decode_ms'])}")


# ---------------------------------------------------------------------------
# Phase 6: the JAX package's FedAvg programs on the port
# ---------------------------------------------------------------------------

# Two rounds: check (a) reads the global tree the second round's train
# task receives.
PROGRAM_ROUNDS = 2
# Check (b)'s three-party weights: inexact in bf16, their total in f32.
W3 = (0.37, 1.7, 1000.5)
PUSH_KINDS = ("stage", "send", "decode", "place")


def _push_spans():
    """This process's spans of ``PUSH_KINDS``, start on the wall clock:
    ``[kind, up, down, start_s, duration_s, nbytes]``."""
    from rayfed_tpu_torch import tracing

    offset = time.time() - time.perf_counter()
    return [[sp.kind, str(sp.upstream_seq_id), str(sp.downstream_seq_id),
             sp.start_s + offset, sp.duration_s, sp.nbytes]
            for sp in tracing.get_spans() if sp.kind in PUSH_KINDS]


def _int_view(x):
    """``x``'s bits as integers of its width (NaNs compare as bits)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()])


def _lm_program(party, addresses, device, cfg_kw, batch, seq, rounds,
                local_steps, lr):
    """Phase 6's transformer program: the rounds of
    ``rayfed_tpu_torch/examples/federated_transformer.py`` (its
    ``LmWorker`` and ``run``) at ``cfg_kw``'s width, with
    ``transport="cuda"`` on a card ("tcp" on the CPU), plus what the
    parent checks: where the pushed tree landed and the root's aggregate
    against the CPU fold each round, the aggregate's eval loss before and
    after, the final aggregate's digest, each party's kernel launches,
    peak memory and push spans."""
    import numpy as np
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh, topology, tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.examples import federated_transformer as example
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan
    from rayfed_tpu_torch.proxy.tcp import sockio

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    names = [n for n, _ in PARTIES]
    root, other = names
    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp",
             config={"cross_silo_comm": FED_COMM})
    party_dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    eval_launches = dict.fromkeys(fa.LAUNCHES, 0)

    @fed.remote
    def evaluate(params):
        """The loss of ``params`` (the workers' initial params when None)
        on one window of each party's data."""
        if params is None:
            params = tfm.init_params(0, cfg, party_dev)
        blk = torch.as_tensor(np.stack([next(synthetic_lm_dataset(
            cfg.vocab, batch * local_steps * (seq + 1), seq, seed=s
        ).batches(batch, epoch=0))[0] for _, s in PARTIES]),
            device=party_dev).long()
        before = dict(fa.LAUNCHES)
        with torch.no_grad():
            loss = float(tfm.lm_loss_pair(
                params, blk[:, :-1], blk[:, 1:], cfg, fa.make_flash_attn_fn(),
                loss_chunk=512))
        for k in eval_launches:
            eval_launches[k] += fa.LAUNCHES[k] - before[k]
        return loss

    @fed.remote
    def check_round(mine, theirs, agg):
        """At the root, once the round's aggregate is ready: (a) where
        the other party's pushed tree landed, (b) the aggregate, computed
        on the party's device, against the CPU fold of both pushed trees
        taken to host (``reduce_by_plan``: the same sum and divide as
        ``fed_aggregate``); and, since dividing two parties' sum by 2 is
        exact, ``reduce_by_plan`` over three parties (the two pushed
        trees and the aggregate) on the device against the CPU, in f32
        and bf16, as a mean (divide by 3) and weighted by ``W3`` (a
        total inexact in f32, weights inexact in bf16)."""
        started = time.time()

        def host(t):
            return tree_util.tree_map(lambda x: x.detach().cpu(), t)

        def mismatches(xs, ys):
            return sum(int((_int_view(a) != _int_view(b)).sum())
                       for a, b in zip(xs, ys))

        want = reduce_by_plan(topology.plan(names, "flat"),
                              {root: host(mine), other: host(theirs)})
        got = tree_util.tree_flatten(host(agg))[0]
        mismatched = mismatches(got, tree_util.tree_flatten(want)[0])
        # Leaf by leaf, so the device holds one leaf's folds at a time.
        three = [f"p{i}" for i in range(3)]
        plan3 = topology.plan(three, "flat")
        spec = tree_util.tree_flatten(mine)[1]
        mismatched3 = elements3 = 0
        for leaves in zip(tree_util.tree_flatten(mine)[0],
                          tree_util.leaves_like(theirs, spec),
                          tree_util.leaves_like(agg, spec)):
            for dtype in (torch.float32, torch.bfloat16):
                on_dev = dict(zip(three, (x.to(dtype) for x in leaves)))
                on_cpu = {p: x.cpu() for p, x in on_dev.items()}
                for w in (None, dict(zip(three, W3))):
                    mismatched3 += mismatches(
                        [reduce_by_plan(plan3, on_dev, w).cpu()],
                        [reduce_by_plan(plan3, on_cpu, w)])
                    elements3 += leaves[0].numel()
        return dict(
            started=started, check_s=time.time() - started,
            mismatched=mismatched,
            elements=sum(x.numel() for x in got),
            mismatched3=mismatched3, elements3=elements3,
            landed=sorted({str(x.device)
                           for x in tree_util.tree_flatten(theirs)[0]}),
            folded_on=sorted({str(x.device)
                              for x in tree_util.tree_flatten(agg)[0]}))

    @fed.remote
    def report():
        return dict(
            launches={k: n - eval_launches[k] for k, n in fa.LAUNCHES.items()},
            eval_launches=dict(eval_launches),
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if on_cuda else None),
            io_path=sockio.io_path(), spans=_push_spans())

    workers = {n: example.LmWorker.party(n).remote(
        seed, cfg, batch=batch, seq=seq, local_steps=local_steps, lr=lr,
        device=None if on_cuda else "cpu") for n, seed in PARTIES}
    evals = [fed.get(evaluate.party(root).remote(None))]
    checks, starts, last = [], [time.time()], {}

    def on_round(r, locals_, global_params):
        checks.append(fed.get(check_round.party(root).remote(
            locals_[root], locals_[other], global_params)))
        last["aggregate"] = global_params
        starts.append(time.time())

    final = example.run(party, workers, rounds=rounds, on_round=on_round)
    evals.append(fed.get(evaluate.party(root).remote(last["aggregate"])))
    received = fed.get([workers[n].received_devices.remote() for n in names])
    reports = fed.get([report.party(n).remote() for n in names])
    digest = _tree_digest(final)
    fed.shutdown()
    # A round: from its first submit to its aggregate ready at the root
    # (the check task starts then), the checks left out.
    walls = [c["started"] - t for c, t in zip(checks, starts)]
    return dict(party=party, party_device=str(party_dev), evals=evals,
                checks=checks, round_walls=walls, digest=digest,
                received=dict(zip(names, received)),
                reports=dict(zip(names, reports)))


def _cnn_program(party, addresses, device, rounds):
    """Phase 6's CNN program: ``rayfed_tpu_torch/examples/fedavg_cnn.py``
    (wmean over the 640/384 shards) for ``rounds`` rounds."""
    import torch

    from rayfed_tpu_torch.examples import fedavg_cnn

    on_cuda = torch.device(device).type == "cuda"
    out = fedavg_cnn.run(party, addresses, rounds=rounds,
                         device=None if on_cuda else "cpu",
                         transport="cuda" if on_cuda else "tcp",
                         comm=FED_COMM)
    return dict(digest=out["digest"], loss=out["loss"])


def pushes(reports):
    """Each push of a tensor tree, from both parties' spans: the sender's
    host staging (``stage``) and socket send, the receiver's decode and,
    on the CUDA lane, the placement on its card inside the decode. The
    total runs from the staging's start (the pushed value resolved) to
    the receiver's placement's end (its decode's on the TCP lane)."""
    spans = {}
    for party, rep in reports.items():
        for kind, up, down, start, dur, nbytes in rep["spans"]:
            spans.setdefault((up, down), {})[kind] = (party, start, dur,
                                                      nbytes)
    out = []
    for key, got in spans.items():
        if "stage" not in got or "decode" not in got or got["stage"][3] == 0:
            continue
        sender, t0 = got["stage"][:2]
        receiver, start, dur, nbytes = got.get("place", got["decode"])
        out.append(dict(
            src=sender, dst=receiver, nbytes=nbytes, t0=t0,
            total_ms=1e3 * (start + dur - t0),
            **{f"{k}_ms": 1e3 * got[k][2] if k in got else None
               for k in PUSH_KINDS}))
    return sorted(out, key=lambda p: p["t0"])


def phase_programs(device, cfg, *, batch, seq, rounds=PROGRAM_ROUNDS,
                   local_steps=2, lr=1e-3, label="",
                   timeout_s=FED_JOIN_TIMEOUT_S, kernels=BF16_KERNELS,
                   cnn=True):
    """Phase 6: the JAX package's FedAvg programs on the port, each in
    two spawned party processes: the transformer program (``fed_aggregate``
    mean) at ``cfg``'s width, checked: (a) every received tree is on the
    receiving party's device in the consuming task, (b) the root's
    aggregate on its device is bitwise the CPU fold of the two pushed
    trees, (c) both parties' ``fed.get`` of the final aggregate hash the
    same, (d) the aggregate's loss falls, (e) each party's steps launched
    every one of ``kernels`` and no other bf16 flash kernel, (f) both
    parties ran the native IO path; then, with ``cnn``, the CNN program
    (``FedAvgTrainer``, wmean), whose two digests must agree. Returns the
    transformer program's results."""
    import dataclasses

    import torch

    on_cuda = torch.device(device).type == "cuda"
    root, other = (n for n, _ in PARTIES)
    results, wall = spawn_parties(
        _lm_program, (device, dataclasses.asdict(cfg), batch, seq, rounds,
                      local_steps, lr), timeout_s)
    res = results[root]
    require(all(results[other][k] == res[k]
                for k in ("evals", "checks", "received", "reports")),
            "the parties disagree on values both fetched through fed.get")
    devices = {n: results[n]["party_device"] for n in results}
    for r, chk in enumerate(res["checks"]):
        require(chk["landed"] == [devices[root]],
                f"(a) round {r}: {other}'s tree reached the root's task on "
                f"{chk['landed']}, not {devices[root]}")
        require(chk["folded_on"] == [devices[root]] and chk["mismatched"] == 0,
                f"(b) round {r}: the aggregate on {chk['folded_on']} differs "
                f"from the CPU fold in {chk['mismatched']} of "
                f"{chk['elements']} elements")
        require(chk["mismatched3"] == 0,
                f"(b) round {r}: the three-party folds on "
                f"{chk['folded_on']} differ from the CPU's in "
                f"{chk['mismatched3']} of {chk['elements3']} elements")
    require(res["received"][other] == [devices[other]],
            f"(a) {other}'s worker got the global tree on "
            f"{res['received'][other]}, not {devices[other]}")
    require(results[other]["digest"] == res["digest"],
            "(c) the parties' final aggregates hash differently")
    require(res["evals"][-1] < res["evals"][0],
            f"(d) the aggregate's loss did not fall: {res['evals']}")
    if on_cuda:
        others = [k for k in BF16_KERNELS + WIDE_KERNELS if k not in kernels]
        for n, rep in res["reports"].items():
            require(all(rep["launches"][k] > 0 for k in kernels)
                    and not any(rep["launches"][k] for k in others),
                    f"(e) party {n}'s train steps did not launch every "
                    f"kernel of {kernels} and none of {others}: "
                    f"{rep['launches']}")
    paths = {n: rep["io_path"] for n, rep in res["reports"].items()}
    require(set(paths.values()) == {"native"},
            f"(f) the parties ran IO paths {paths}, not the native one")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    push_list = pushes(res["reports"])
    print(f"[programs] {label} federated_transformer: two party processes "
          f"({devices}, IO path {paths}), {rounds} rounds in {wall:.1f} s "
          f"from spawn to exit; round walls "
          + ", ".join(f"{w:.2f} s" for w in res["round_walls"])
          + "; the root's checks of each round "
          + ", ".join(f"{c['check_s']:.2f} s" for c in res["checks"]))
    print(f"[programs] {label} aggregate eval loss {res['evals']}; fold "
          f"bitwise each round ({res['checks'][0]['elements']} elements; "
          f"three-party folds {res['checks'][0]['elements3']} elements); "
          f"final digests equal")
    for p in push_list:
        place = p["place_ms"]
        print(f"[programs] {label} push {p['src']} -> {p['dst']} "
              f"{p['nbytes']} B: {p['total_ms']:.1f} ms, "
              f"{p['nbytes'] / p['total_ms'] / 1e6:.3f} GB/s; host staging "
              f"{ms(p['stage_ms'])}, send {ms(p['send_ms'])}, decode "
              f"{ms(p['decode_ms'])}, of which placement on the card "
              f"{ms(place)}")
    for n, rep in res["reports"].items():
        print(f"[programs] {label} party {n}: train launches "
              f"{rep['launches']}, evaluations {rep['eval_launches']}, "
              f"max_memory_allocated {rep['max_memory_allocated']}")
    out = dict(results=results, pushes=push_list, wall_s=wall)
    if cnn:
        got, out["cnn_wall_s"] = spawn_parties(_cnn_program,
                                               (device, rounds), timeout_s)
        require(got[root]["digest"] == got[other]["digest"],
                "the CNN program's parties hold different final aggregates")
        print(f"[programs] {label} fedavg_cnn: {rounds} rounds (wmean) in "
              f"{out['cnn_wall_s']:.1f} s from spawn to exit, digests "
              f"equal, local losses {got[root]['loss']:.4f} / "
              f"{got[other]['loss']:.4f}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the serving plane on the card
# ---------------------------------------------------------------------------

# The served configuration: ServingConfig's defaults (paged KV in 16-position
# blocks, prefill chunks of 32 under a 64-token budget, prefix reuse on)
# but for these.
SERVE_CFG = dict(max_slots=8, max_len=1024, max_new_tokens=64,
                 max_pending=64)
# The traffic. From bench.py's serving cell (``_serve_bench_entry``): as
# many client threads as the pool has slots, 4 requests each, submitted
# one after another, 32 in all, served again in ``mode="sequential"``.
# Assumed, from no source: the lengths. bench.py's cell serves prompts of
# 4-12 tokens and 48 new tokens at max_len 64; here prompt lengths are
# drawn uniformly in 16-512 from a seed and 64 tokens are generated, at
# max_len 1024. One swap, after a third of the completions (bench.py
# swaps twice).
SERVE_REQUESTS = 32
SERVE_CLIENTS = SERVE_CFG["max_slots"]
SERVE_PROMPT_LEN = (16, 512)
SERVE_SEED = 7
# Check (d): f32 compute at this depth; each logits vector within this
# fraction of the full forward's norm.
SERVE_F32_LAYERS = 2
SERVE_LOGIT_TOL = 1e-4
# The two-process run: its depth, requests and join timeout.
SERVE_FED_LAYERS = 1
# Phase 7's depth in the whole run: cut from the flagship's 12 so that
# the run fits its budget (depth 1: runs at depth 8 or 12 are not
# comparable); --serving-only keeps full depth.
SERVE_LAYERS = 1
SERVE_FED_REQUESTS = 8
# Phase 7's two-process part (phase 7: 57.2 s).
SERVE_FED_TIMEOUT_S = 150


def serve_prompts(n, lo, hi, vocab, seed=SERVE_SEED):
    """``n`` prompts (lists of token ids), lengths uniform in [lo, hi]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [[int(t) for t in rng.integers(1, vocab, int(m))] for m in lens]


def drive_server(srv, prompts, clients, swap=None):
    """Serve ``prompts`` from ``clients`` threads (client c submits
    requests c, c+clients, ... one after another); with ``swap``
    (params), the client whose completion makes a third of them publishes
    it. Returns the responses in request order, the window from the first
    submit to the last completion in seconds, and the publish's ms. Any
    failed request raises."""
    import threading

    import torch

    n = len(prompts)
    out = [None] * n
    errors = []
    lock = threading.Lock()
    done = [0]
    publish_ms = [None]
    on_cuda = srv.device.type == "cuda"

    def client(c):
        try:
            for i in range(c, n, clients):
                out[i] = srv.submit_and_wait(prompts[i])
                with lock:
                    done[0] += 1
                    fire = swap is not None and done[0] == max(1, n // 3)
                if fire:
                    t = time.perf_counter()
                    srv.publish(swap)
                    if on_cuda:
                        torch.cuda.synchronize()
                    publish_ms[0] = 1e3 * (time.perf_counter() - t)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    window = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads),
            "(e) the serving clients did not finish within 600 s")
    require(not errors, f"(e) a request failed: {errors[:1]!r}")
    return out, window, publish_ms[0]


def warm_server(srv):
    """Serve, one at a time and 2 new tokens each, discarded requests
    that run every program shape a timed window can reach: each whole
    prefill bucket up to the prefill chunk, a ragged first chunk of each
    chunk bucket before a full chunk, and the decode step (as bench.py
    warms every prompt bucket, so that the window measures the
    scheduler). Returns how many were served."""
    chunk = srv.scfg.prefill_chunk
    lens = sorted({b for b in srv._buckets if b <= chunk}
                  | {chunk + b for b in srv._chunk_buckets})
    lens = [n for n in lens if n + 2 <= srv.scfg.max_len]
    for n in lens:
        srv.submit_and_wait(list(range(1, n + 1)), max_new_tokens=2)
    return len(lens)


class _ProgramTimer:
    """Wraps one of the engine's device programs. On the card, a CUDA
    event pair around each call, read after the window, so the engine
    never waits for them and a timed window runs the code an untimed one
    does; on the CPU the host clock. With ``junk`` (the pool's sacrificial
    position) it also counts each decode step's live rows."""

    def __init__(self, fn, on_cuda, junk=None):
        self.fn, self.on_cuda, self.junk = fn, on_cuda, junk
        self.calls, self.live = [], []

    def __call__(self, *args, **kwargs):
        import numpy as np
        import torch

        if self.junk is not None:
            positions = args[5] if len(args) > 5 else kwargs["positions"]
            self.live.append(int(np.count_nonzero(
                np.asarray(positions) != self.junk)))
        if not self.on_cuda:
            t = time.perf_counter()
            out = self.fn(*args, **kwargs)
            self.calls.append(1e3 * (time.perf_counter() - t))
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.calls.append((start, end))
        return out

    def reset(self):
        self.calls, self.live = [], []

    def ms(self):
        if not self.on_cuda:
            return list(self.calls)
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.calls]


class _TimedPrograms:
    """Patches the server module's device programs with
    :class:`_ProgramTimer` for the ``with`` block."""

    NAMES = ("decode_step", "chunk_row", "prefill_row")

    def __init__(self, srv_mod, on_cuda, junk):
        self.mod = srv_mod
        self.t = {n: _ProgramTimer(getattr(srv_mod, n), on_cuda,
                                   junk if n == "decode_step" else None)
                  for n in self.NAMES}

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.NAMES}
        for n, t in self.t.items():
            setattr(self.mod, n, t)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.mod, n, f)

    def reset(self):
        for t in self.t.values():
            t.reset()


def host_state(device):
    """What shares this process's host at a window's start: the load
    average, live threads, child processes, objects the garbage collector
    tracks, and a launch probe (the host's microseconds per launch of a
    one-element add on ``device``, 2000 launches, synchronized once)."""
    import gc
    import multiprocessing
    import threading

    import torch

    x = torch.zeros(1, device=device)
    on_cuda = x.device.type == "cuda"
    for _ in range(100):
        x.add_(1)
    if on_cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    if on_cuda:
        torch.cuda.synchronize()
    launch_us = 1e6 * (time.perf_counter() - t) / 2000
    return dict(loadavg_1m=os.getloadavg()[0],
                threads=threading.active_count(),
                children=len(multiprocessing.active_children()),
                gc_objects=len(gc.get_objects()), launch_us=launch_us)


def _tokens(resps):
    return [r["tokens"] for r in resps]


def _near(got, want, what):
    """Check (d): ``got``'s distance to ``want`` within SERVE_LOGIT_TOL of
    ``want``'s norm; returns the ratio."""
    import torch

    ratio = float(torch.linalg.vector_norm(got.float() - want.float())
                  / torch.linalg.vector_norm(want.float()))
    require(ratio <= SERVE_LOGIT_TOL,
            f"(d) {what}: error {ratio:.3g} of the reference's norm > "
            f"{SERVE_LOGIT_TOL}")
    return ratio


def serving_logits_check(device, cfg, prompt_short, prompt_long, scfg_kw):
    """Check (d): at f32 compute, the engine's prefill logits (a short
    prompt whole, a long one in its chunks) and its first decode step
    against a full forward of the prompt and of prompt + token."""
    import dataclasses

    import numpy as np
    import torch

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.serving import server as srv_mod
    from rayfed_tpu_torch.serving.kv_pool import KVPool

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_F32_LAYERS,
                                compute_dtype=torch.float32)
    scfg = srv_mod.ServingConfig(**scfg_kw)
    params = tfm.init_params(SERVE_SEED + 10, cfg32, device=device)
    pool = KVPool(cfg32, 3, scfg.max_len, device=device)
    chunk_buckets = sorted({min(b, scfg.prefill_chunk) for b in
                            srv_mod._default_buckets(scfg.prefill_chunk)})
    buckets = srv_mod._default_buckets(scfg.max_len)
    ratios = {}
    firsts = []
    with torch.no_grad():
        for row, prompt in ((1, prompt_short), (2, prompt_long)):
            p = np.asarray(prompt, np.int64)
            k, v = pool.row(row)
            if p.size <= scfg.prefill_chunk:
                last = srv_mod.prefill_row(
                    params, cfg32, k, v, p,
                    next(b for b in buckets if b >= p.size))
            else:
                for off, real, clen in srv_mod.chunk_plan(
                        p.size, scfg.prefill_chunk, chunk_buckets):
                    toks = np.zeros(clen, np.int64)
                    toks[:real] = p[off:off + real]
                    logits = srv_mod.chunk_row(params, cfg32, k, v, toks, off)
                last = logits[real - 1]
            full = tfm.forward(params, torch.tensor([prompt], device=device),
                               cfg32)[0, -1]
            ratios[f"prefill_{p.size}"] = _near(last, full,
                                                f"prefill of {p.size}")
            firsts.append(int(torch.argmax(last)))
        kk, vv = pool.kv
        step = srv_mod.decode_step(
            params, cfg32, kk, vv, np.array([0] + firsts),
            np.array([pool.junk_pos, len(prompt_short), len(prompt_long)]))
        for row, prompt in ((1, prompt_short), (2, prompt_long)):
            ext = tfm.forward(params, torch.tensor(
                [prompt + [firsts[row - 1]]], device=device), cfg32)[0, -1]
            ratios[f"step_{len(prompt)}"] = _near(
                step[row], ext, f"first step after {len(prompt)}")
    return ratios


def profile_decode_step(device, cfg, params, scfg_kw, positions):
    """One paged decode iteration as the engine runs it (params cast to
    the compute dtype once, as the engine holds them; gather the rows'
    blocks, the batched step, scatter the written positions) with pool
    row r live at ``positions[r]``, under ``torch.profiler``: device ms
    by kind, busy and wall ms, idle share."""
    import numpy as np

    from rayfed_tpu_torch.models import decode
    from rayfed_tpu_torch.serving import server as srv_mod
    from rayfed_tpu_torch.serving.kv_pool import PagedKVPool

    scfg = srv_mod.ServingConfig(**scfg_kw)
    pool = PagedKVPool(cfg, scfg.max_slots, scfg.max_len, device=device,
                       block_size=scfg.kv_block_size)
    r = scfg.max_slots
    positions = np.asarray(positions, np.int64)
    for s in range(r):
        require(pool.acquire() is not None, "profile pool has no slot")
        require(pool.ensure_blocks(s, int(positions[s])) == "ok",
                "profile pool full")
    tables = np.stack([pool.table(s) for s in range(r)])
    targets = [pool.write_target(s, int(positions[s])) for s in range(r)]
    wb = np.array([t[0] for t in targets], np.int64)
    wo = np.array([t[1] for t in targets], np.int64)
    tokens = np.arange(1, r + 1, dtype=np.int64)
    params = decode.cast_params(params, cfg)

    def step():
        import torch

        with torch.no_grad():
            k, v = pool.gather(tables)
            logits = srv_mod.decode_step(params, cfg, k, v, tokens, positions)
            pool.scatter_step(k, v, positions, wb, wo)
            return srv_mod._to_host(logits)

    step()  # warm the allocator
    # A process's first profiler session sets CUPTI up and reads heavier.
    device_breakdown(step)
    return device_breakdown(step)


def prefill_costs(device, cfg, params, prompts, scfg_kw, reps=3):
    """What holding the two KV layouts to the same bits costs in prefill,
    on ``prompts`` (the traffic's): (1) the slab layout prefills a prompt
    longer than the chunk in the paged layout's chunks, where the JAX
    package's slab layout runs it whole: both, per prompt; (2) the paged
    layout prefills each short prompt as a batch-1 forward, where the JAX
    package runs one (max_slots, bucket) forward for every short prompt
    admitted in a round: one of each at the chunk's length, median of
    ``reps``. The forwards only (params cast once, as the engine holds
    them; a fresh cache row each, no scatter), the device synchronized
    around each. Returns ms."""
    import statistics as stats_mod

    import numpy as np
    import torch

    from rayfed_tpu_torch.models import decode
    from rayfed_tpu_torch.serving import server as srv_mod

    scfg = srv_mod.ServingConfig(**scfg_kw)
    chunk, T, R = scfg.prefill_chunk, scfg.max_len + 1, scfg.max_slots
    buckets = srv_mod._default_buckets(scfg.max_len)
    chunk_buckets = sorted({min(b, chunk) for b in
                            srv_mod._default_buckets(chunk)})
    params = decode.cast_params(params, cfg)
    on_cuda = torch.device(device).type == "cuda"

    def timed(fn):
        if on_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if on_cuda:
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    def row():
        c = decode.init_cache(cfg, 1, T, device=device)
        return c["k"], c["v"]

    def chunked(p):
        k, v = row()
        for off, real, clen in srv_mod.chunk_plan(p.size, chunk,
                                                  chunk_buckets):
            toks = np.zeros(clen, np.int64)
            toks[:real] = p[off:off + real]
            srv_mod.chunk_row(params, cfg, k, v, toks, off)

    def whole(p):
        k, v = row()
        srv_mod.prefill_row(params, cfg, k, v, p,
                            next(b for b in buckets if b >= p.size))

    def batched():
        c = decode.init_cache(cfg, R, T, device=device)
        toks = torch.ones((R, chunk), dtype=torch.int64, device=c["k"].device)
        decode.forward_with_cache(params, toks, c, 0, cfg)

    short = np.arange(1, chunk + 1, dtype=np.int64)
    out = dict(chunked_ms=[], whole_ms=[], n_short=0)
    with torch.no_grad():
        whole(short)  # warm
        for prompt in prompts:
            p = np.asarray(prompt, np.int64)
            if p.size <= chunk:
                out["n_short"] += 1
                continue
            out["chunked_ms"].append(timed(lambda: chunked(p)))
            out["whole_ms"].append(timed(lambda: whole(p)))
        batched()  # warm
        out["batch1_ms"] = stats_mod.median(
            timed(lambda: whole(short)) for _ in range(reps))
        out["batched_ms"] = stats_mod.median(
            timed(batched) for _ in range(reps))
    return out


def phase_serving(device, cfg, *, scfg_kw=None, n_requests=SERVE_REQUESTS,
                  clients=SERVE_CLIENTS, prompt_len=SERVE_PROMPT_LEN,
                  label=""):
    """Phase 7, the single-process run: ``cfg`` (bf16 compute, f32 params
    from a seed, bf16 KV) served by the port's ``InferenceServer`` on
    ``device`` under SERVE_CFG, with the traffic of :func:`drive_server`
    after :func:`warm_server`. Checks: (a) every response equals the same
    request served alone (``mode="sequential"``, same shape) on its
    pinned version; (b) the slab layout gives the paged layout's tokens
    on the same traffic without the swap; (c) a rerun gives the same
    tokens; (d) :func:`serving_logits_check`; (e) no request fails and
    the swap is counted. Prints the host's state, TTFT, decode tokens/s,
    the decode step's and a prefill chunk's ms and the live rows per step
    (CUDA events, in both windows), the sequential window and the
    speedup, the publish's ms and zero-copy adoptions, the pool's bytes
    and peak memory, :func:`prefill_costs`, and one profiled decode step
    at a state the traffic reaches."""
    import statistics as stats_mod

    import numpy as np
    import torch

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.serving import server as srv_mod

    scfg_kw = dict(SERVE_CFG if scfg_kw is None else scfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    params_a = tfm.init_params(SERVE_SEED, cfg, device=device)
    params_b = tfm.init_params(SERVE_SEED + 1, cfg, device=device)
    hi = min(prompt_len[1], scfg_kw["max_len"] - scfg_kw["max_new_tokens"])
    prompts = serve_prompts(n_requests, prompt_len[0], hi, cfg.vocab)

    def server(**kw):
        return srv_mod.InferenceServer(
            cfg, srv_mod.ServingConfig(**dict(scfg_kw, **kw)),
            params=params_a, device=device)

    walls = {}  # each run's wall, spawn of its server to its stop
    t_run = time.perf_counter()

    def lap(name):
        nonlocal t_run
        now = time.perf_counter()
        walls[name] = now - t_run
        t_run = now

    def timed_window(mode):
        """A warmed server in ``mode`` serves the traffic with the swap,
        its programs timed; returns the responses, window, publish ms,
        stats, pool bytes and the timers."""
        with _TimedPrograms(srv_mod, on_cuda, scfg_kw["max_len"]) as tp:
            srv = server(mode=mode)
            try:
                n_warm = warm_server(srv)
                tp.reset()
                resps, window, publish_ms = drive_server(
                    srv, prompts, clients, swap=params_b)
                st = srv.stats()
                pool_bytes = srv.pool.nbytes
            finally:
                srv.stop()
        require(st["swaps"] == 2 and st["completed"] == n_requests + n_warm,
                f"(e) the {mode} run counted {st['swaps']} swaps and "
                f"{st['completed']} completions ({n_warm} warming): {st}")
        return resps, window, publish_ms, st, pool_bytes, tp.t

    host = host_state(device)
    # The main run: continuous batching over the paged pool, the swap
    # after a third; then the naive baseline on the same traffic, one
    # request at a time. Both warmed, both timed alike.
    fa.reset_launch_counts()
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    main, window, publish_ms, st, pool_bytes, timers = timed_window(
        "continuous")
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    serve_launches = dict(fa.LAUNCHES)
    versions = [r["version"] for r in main]
    require(set(versions) <= {1, 2}, f"(e) versions {versions}")
    lap("main")
    seq_resps, seq_window, _, _, _, seq_timers = timed_window("sequential")
    lap("sequential")

    # (a): each response against the request served alone on its
    # version; the sequential run served each alone on the version it
    # pinned, the rest run alone here.
    alone = {(i, r["version"]): r["tokens"] for i, r in enumerate(seq_resps)}
    for v, params in ((1, params_a), (2, params_b)):
        todo = [i for i, r in enumerate(main) if r["version"] == v
                and (i, v) not in alone]
        if not todo:
            continue
        srv = srv_mod.InferenceServer(
            cfg, srv_mod.ServingConfig(**dict(scfg_kw, mode="sequential")),
            params=params, device=device)
        try:
            for i in todo:
                alone[(i, v)] = srv.submit_and_wait(prompts[i])["tokens"]
        finally:
            srv.stop()
    mixed = [i for i, r in enumerate(main)
             if r["tokens"] != alone[(i, r["version"])]]
    require(not mixed, f"(a) responses {mixed} differ from the same request "
                       "served alone on its version")
    lap("alone")

    # (b), (c): paged, slab, paged again, all without the swap.
    runs = {}
    for name, layout in (("paged", "paged"), ("slab", "slab"),
                         ("paged_again", "paged")):
        srv = server(kv_layout=layout)
        try:
            runs[name] = _tokens(drive_server(srv, prompts, clients)[0])
        finally:
            srv.stop()
        lap(name)
    differ = [i for i, (a, b) in enumerate(zip(runs["paged"], runs["slab"]))
              if a != b]
    require(not differ, f"(b) the slab layout's tokens differ from the "
                        f"paged layout's for requests {differ}")
    require(runs["paged_again"] == runs["paged"],
            "(c) a fixed-seed rerun gave different tokens")

    # (d) at f32.
    by_len = sorted(prompts, key=len)
    ratios = serving_logits_check(
        device, cfg, by_len[0][:scfg_kw.get("prefill_chunk", 32)],
        by_len[-1], scfg_kw)
    lap("f32_check")
    costs = prefill_costs(device, cfg, params_a, prompts, scfg_kw)
    lap("prefill_costs")
    # The profiled iteration: every row live, as the traffic's first
    # max_slots requests are together, each halfway through its tokens.
    r = scfg_kw["max_slots"]
    prof_pos = [len(p) + scfg_kw["max_new_tokens"] // 2 for p in prompts[:r]]
    prof_pos += [prof_pos[-1]] * (r - len(prof_pos))
    breakdown = profile_decode_step(device, cfg, params_a, scfg_kw, prof_pos)
    lap("profile")

    ttft = [1e3 * (r["timing"]["first_token"] - r["timing"]["enqueue"])
            for r in main]
    n_tokens = sum(len(r["tokens"]) for r in main)
    step_ms, chunk_ms, prefill_ms = (timers[n].ms() for n in (
        "decode_step", "chunk_row", "prefill_row"))
    seq_step_ms = seq_timers["decode_step"].ms()
    live = timers["decode_step"].live

    def med(xs):
        return stats_mod.median(xs) if xs else None

    summary = dict(
        window_s=window, seq_window_s=seq_window,
        speedup=seq_window / window, tokens=n_tokens,
        tokens_per_s=n_tokens / window,
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p99_ms=float(np.percentile(ttft, 99)),
        step_ms=med(step_ms), steps=len(step_ms), chunk_ms=med(chunk_ms),
        chunks=len(chunk_ms), prefills=len(prefill_ms),
        prefill_ms=med(prefill_ms), seq_step_ms=med(seq_step_ms),
        live_rows_mean=float(np.mean(live)) if live else None,
        live_rows_full=(sum(n == r for n in live) / len(live)
                        if live else None),
        publish_ms=publish_ms, zerocopy=st["publish_zerocopy"],
        pool_bytes=pool_bytes, max_memory_allocated=peak,
        versions={v: versions.count(v) for v in (1, 2)},
        logit_ratios=ratios, breakdown=breakdown, prefill_costs=costs,
        profiled_positions=prof_pos, host=host,
        flash_launches=serve_launches, prefix_hits=st["prefix_hits"],
        prefill_chunks=st["prefill_chunks"], stats_steps=st["steps"],
        walls=walls,
    )

    def ms(x):
        return "not measured" if x is None else f"{x:.2f} ms"

    print(f"[serve] {label} host at the start: "
          + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in host.items()))
    print(f"[serve] {label} {n_requests} requests from {clients} clients, "
          f"prompts {prompt_len[0]}-{hi} tokens, {scfg_kw}: window "
          f"{window:.3f} s, {n_tokens} tokens, {summary['tokens_per_s']:.1f} "
          f"decode tokens/s; versions {summary['versions']}")
    print(f"[serve] {label} TTFT p50 {summary['ttft_p50_ms']:.1f} ms, p99 "
          f"{summary['ttft_p99_ms']:.1f} ms; decode step median "
          f"{ms(summary['step_ms'])} over {len(step_ms)} steps, live rows "
          f"per step mean {summary['live_rows_mean']:.2f}, all {r} live in "
          f"{summary['live_rows_full']:.3f} of them; prefill chunk median "
          f"{ms(summary['chunk_ms'])} over {len(chunk_ms)} chunks, whole "
          f"prefill median {ms(summary['prefill_ms'])} over "
          f"{len(prefill_ms)}")
    print(f"[serve] {label} mode=sequential on the same traffic: window "
          f"{seq_window:.3f} s, decode step median "
          f"{ms(summary['seq_step_ms'])}; continuous batching speedup "
          f"{summary['speedup']:.2f}x")
    print(f"[serve] {label} publish of a {_tree_nbytes(params_b)} B tree: "
          + ("not measured" if publish_ms is None else f"{publish_ms:.1f} ms")
          + f"; zero-copy adoptions {summary['zerocopy']} (the bank on "
          f"{device} copies a leaf it cannot adopt, and the card's always)")
    print(f"[serve] {label} KV pool {pool_bytes} B; max_memory_allocated "
          f"{peak}; flash kernel launches while serving {serve_launches}")
    ch, wh = costs["chunked_ms"], costs["whole_ms"]
    print(f"[serve] {label} prefill costs: {len(ch)} prompts over the chunk, "
          f"in chunks {sum(ch):.1f} ms (median {ms(med(ch))}) vs whole "
          f"{sum(wh):.1f} ms (median {ms(med(wh))}); {costs['n_short']} "
          f"short prompts; one batch-1 prefill of {scfg_kw.get('prefill_chunk', 32)}"
          f" tokens {ms(costs['batch1_ms'])} vs one {r}-row batched "
          f"{ms(costs['batched_ms'])}")
    print(f"[serve] {label} checks: (a) {n_requests} responses equal the "
          f"request alone on its version, (b) slab == paged, (c) rerun "
          f"equal, (d) f32 logits vs full forward "
          + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items())
          + f", (e) no failure, {st['swaps']} swaps")
    print(f"[serve] {label} walls, s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    print_breakdown("[serve]", f"{label} paged decode iteration "
                    f"({r} rows live at positions {prof_pos}):", breakdown)
    return summary


def _serve_program(party, addresses, device, cfg_kw, scfg_kw, n_requests,
                   prompt_len):
    """Phase 7's two-process run, one party: ``fed.serve("alice", ...)``;
    the requests go through the handle (their responses cross to bob over
    TCP); mid-load a ``fed_aggregate(..., publish_to=handle)`` of both
    parties' trees hot-publishes version 2. Alice then serves every
    request alone on its version (``mode="sequential"``) and reports the
    mismatches."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh
    from rayfed_tpu_torch.federated import fed_aggregate
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.serving import server as srv_mod

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    root, other = (n for n, _ in PARTIES)
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp",
             config={"cross_silo_comm": FED_COMM, "serving": scfg_kw})
    dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    seeds = dict(PARTIES)

    @fed.remote
    def party_tree(seed):
        return tfm.init_params(SERVE_SEED + 100 + seed, cfg, device=dev)

    params1 = (tfm.init_params(SERVE_SEED + 100, cfg, device=dev)
               if party == root else None)
    handle = fed.serve(root, cfg, params=params1,
                       device=None if on_cuda else "cpu")
    trees = {n: party_tree.party(n).remote(s) for n, s in seeds.items()}
    prompts = serve_prompts(n_requests, prompt_len[0], prompt_len[1],
                            cfg.vocab, seed=SERVE_SEED + 1)
    half = n_requests // 2
    t0 = time.perf_counter()
    futs = [handle.submit(p) for p in prompts[:half]]
    fed_aggregate(trees, op="mean", publish_to=handle)
    if party == root:
        bank = srv_mod.get_server().bank
        deadline = time.monotonic() + 120
        while bank.current_version() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        in_flight = srv_mod.get_server().stats()["active"]
    futs += [handle.submit(p) for p in prompts[half:]]
    resps = [fed.get(f) for f in futs]
    wall = time.perf_counter() - t0
    stats = fed.get(handle.stats())
    out = dict(versions=[r["version"] for r in resps],
               tokens=[r["tokens"] for r in resps], wall_s=wall,
               swaps=stats["swaps"], party_device=str(dev))
    if party == root:
        srv = srv_mod.get_server()
        refs = {1: params1, 2: srv.bank.get(2)}
        alone = {}
        for v, params in refs.items():
            ref = srv_mod.InferenceServer(
                cfg, srv_mod.ServingConfig(**dict(scfg_kw, mode="sequential")),
                params=params, device=dev, name=f"ref{v}")
            try:
                for i, r in enumerate(resps):
                    if r["version"] == v:
                        alone[i] = ref.submit_and_wait(prompts[i])["tokens"]
            finally:
                ref.stop()
        out.update(mismatched=[i for i, r in enumerate(resps)
                               if r["tokens"] != alone[i]],
                   in_flight_at_publish=in_flight,
                   max_memory_allocated=(torch.cuda.max_memory_allocated()
                                         if on_cuda else None))
    fed.get(handle.shutdown())
    fed.shutdown()
    return out


def phase_serve_fed(device, cfg, *, scfg_kw=None,
                    n_requests=SERVE_FED_REQUESTS,
                    prompt_len=SERVE_PROMPT_LEN, label="",
                    timeout_s=SERVE_FED_TIMEOUT_S):
    """Phase 7's two-process run (:func:`_serve_program`): every response
    names its version, both parties got the same responses, and each
    equals alice's local reference for its version; both versions
    served."""
    import dataclasses

    scfg_kw = dict(SERVE_CFG if scfg_kw is None else scfg_kw)
    hi = min(prompt_len[1], scfg_kw["max_len"] - scfg_kw["max_new_tokens"])
    results, wall = spawn_parties(
        _serve_program, (device, dataclasses.asdict(cfg), scfg_kw,
                         n_requests, (prompt_len[0], hi)), timeout_s)
    root, other = (n for n, _ in PARTIES)
    res = results[root]
    require(results[other]["tokens"] == res["tokens"]
            and results[other]["versions"] == res["versions"],
            "the parties got different responses")
    require(set(res["versions"]) == {1, 2},
            f"the hot publish did not serve: versions {res['versions']}")
    require(not res["mismatched"],
            f"responses {res['mismatched']} differ from alice's reference "
            "for their version")
    require(res["swaps"] == 2, f"swaps {res['swaps']}")
    print(f"[serve-fed] {label} fed.serve on {root} ({res['party_device']}), "
          f"{n_requests} requests through the handle, fed_aggregate("
          f"publish_to=) mid-load ({res['in_flight_at_publish']} requests in "
          f"flight when version 2 landed): versions {res['versions']}, all "
          f"equal to {root}'s reference; {res['wall_s']:.2f} s from the "
          f"first submit to the last response, {wall:.1f} s from spawn to "
          f"exit; {root} max_memory_allocated {res['max_memory_allocated']}")
    return dict(results=results, wall_s=wall)


def phase_serving_all(serve_cfg, smi):
    """Phase 7: the serving plane, at ``serve_cfg``'s depth in this
    process, then at SERVE_FED_LAYERS in two party processes."""
    import dataclasses
    import gc

    import torch

    t7 = time.perf_counter()
    phase_serving("cuda", serve_cfg, label=f"on {smi}:")
    gc.collect()
    torch.cuda.empty_cache()
    print("[serve-fed] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], SERVE_FED_LAYERS]}))
    phase_serve_fed("cuda", dataclasses.replace(
        serve_cfg, n_layers=SERVE_FED_LAYERS), label=f"on {smi}:")
    print(f"[serve] phase 7 took {time.perf_counter() - t7:.1f} s on {smi}")


# ---------------------------------------------------------------------------
# Phase 8: async rounds, elastic membership and a job checkpoint
# ---------------------------------------------------------------------------

# The async job: alice is the root (the FedBuff aggregator, the membership
# coordinator, and the serving engine its versions publish into); bob
# trains every round; carol starts outside the roster, joins once version
# 1 is out, offers in round ASYNC_CAROL_ROUND and leaves.
ASYNC_PARTIES = ("alice", "bob", "carol")
ASYNC_ROUNDS = 5
ASYNC_K = 2
ASYNC_JOIN_ROUND = 2
ASYNC_CAROL_ROUND = 3
ASYNC_CUT_VERSION = 2
ASYNC_LOCAL_STEPS = 2
ASYNC_TOKEN = "chip-smoke-async"
# Phase 8's join deadline (phase 8: 77.7 s); its waits inside take a
# half or a quarter of it.
ASYNC_TIMEOUT_S = 220
# bob's seeded straggler schedule: a delay drawn from the seed before each
# of his local trainings, plus a stall in the round before carol's offer
# that also lasts until her offer (a newer round tag) has landed, so that
# his arrives stale.
ASYNC_STRAGGLER = dict(seed=8, jitter_s=0.5, stall_round=ASYNC_CAROL_ROUND - 1,
                       stall_s=8.0)


def _async_trainers(r):
    """The parties that train and offer in round ``r``."""
    return ["bob"] + (["carol"] if r == ASYNC_CAROL_ROUND else [])


def straggler_delays(rounds, seed, jitter_s, stall_round, stall_s):
    """bob's delay before each round's local training, in seconds."""
    import random

    rng = random.Random(seed)
    return [rng.uniform(0.0, jitter_s) + (stall_s if r == stall_round else 0.0)
            for r in range(rounds)]


class _DeviceTimer:
    """Milliseconds between marks: CUDA events on a card (read after a
    synchronize), the host clock on the CPU."""

    def __init__(self, on_cuda):
        self.on_cuda = on_cuda

    def mark(self):
        import torch

        if not self.on_cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b):
        import torch

        if not self.on_cuda:
            return 1e3 * (b - a)
        torch.cuda.synchronize()
        return a.elapsed_time(b)


def _host_tree(tree):
    from rayfed_tpu_torch import tree_util

    return tree_util.tree_map(lambda x: x.detach().cpu(), tree)


def _bitwise_equal(a, b):
    """Whether two trees hold the same bits, leaf by leaf, dicts matched
    by key."""
    import torch

    from rayfed_tpu_torch import tree_util

    xs, spec = tree_util.tree_flatten(_host_tree(a))
    ys = tree_util.leaves_like(_host_tree(b), spec)
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_int_view(x), _int_view(y)) for x, y in zip(xs, ys))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def cpu_async_fold(offers, k, server_lr):
    """The versions an async session publishes from ``offers`` (the
    accepted ones in arrival order: ``party``, host ``tree``, effective
    ``weight``), folded on the CPU as ``BufferedAggregator`` folds them:
    ``reduce_by_plan`` over the arrival slots, then ``tree_mix``."""
    from rayfed_tpu_torch import topology
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan, tree_mix

    versions, current, buf = [], None, []
    for i, off in enumerate(offers):
        buf.append((f"{off['party']}#{i}", off))
        if len(buf) == k:
            plan = topology.plan_buffer([s for s, _ in buf])
            mean = reduce_by_plan(plan, {s: o["tree"] for s, o in buf},
                                  weights={s: o["weight"] for s, o in buf})
            current = tree_mix(current, mean, server_lr)
            versions.append(current)
            buf = []
    return versions


def _wait_for(pred, what, timeout_s):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise SmokeError(f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.02)


def _async_program(party, addresses, device, cfg_kw, batch, seq, workdir,
                   straggler):
    """Phase 8's driver, the same program in every party from the round
    it enters: a membership sync at the top of each round (the one place
    the roster changes), the root's current model fetched, the round's
    trainers each train from it, and ``async_round`` offers their params
    to alice's buffer, which publishes every ``ASYNC_K`` into the serving
    engine alice hosts. alice records each offer, times each fold and
    publish, cuts ``save_job_state`` once version ``ASYNC_CUT_VERSION`` is
    out, and feeds the offers after the cut to a second aggregator
    rebuilt from ``restore_job_state``."""
    import threading

    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import async_rounds, checkpoint, mesh, tracing
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.config import AsyncAggregationConfig
    from rayfed_tpu_torch.data import make_batch_iterator, synthetic_lm_dataset
    from rayfed_tpu_torch.membership.manager import get_membership_manager
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.resilience.liveness import liveness_view

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    transport = "cuda" if on_cuda else "tcp"
    root = ASYNC_PARTIES[0]
    timer = _DeviceTimer(on_cuda)
    config = {
        "cross_silo_comm": FED_COMM,
        "membership": {"coordinator": root, "auth_token": ASYNC_TOKEN,
                       "sync_timeout_s": ASYNC_TIMEOUT_S / 2,
                       "join_timeout_s": ASYNC_TIMEOUT_S / 2},
        "aggregation": {"async_buffer_k": ASYNC_K},
        "serving": {"max_slots": 1, "max_len": 64, "max_new_tokens": 4},
    }
    tracing.enable()
    out = dict(party=party, views=[])
    if party == "carol":
        _wait_for(lambda: os.path.exists(os.path.join(workdir, "v1")),
                  "version 1", ASYNC_TIMEOUT_S / 2)
        t = time.perf_counter()
        bootstrap = fed.join(address=addresses["carol"], party="carol",
                             coordinator=root,
                             coordinator_address=addresses[root],
                             config=config, logging_level="warning",
                             transport=transport,
                             timeout=ASYNC_TIMEOUT_S / 2)
        out["join_ms"] = 1e3 * (time.perf_counter() - t)
        # The coordinator attaches its serving bank's newest version.
        require(bootstrap is not None and bootstrap["kind"] == "model_bank",
                f"carol's bootstrap is {bootstrap and bootstrap['kind']!r}, "
                f"not the root's model bank")
        out["bootstrap"] = dict(version=bootstrap["version"],
                                digest=_tree_digest(bootstrap["params"]))
        entry = get_membership_manager().sync_index() - 1
    else:
        fed.init(addresses={p: addresses[p] for p in ASYNC_PARTIES[:2]},
                 party=party, logging_level="warning", transport=transport,
                 config=dict(config, barrier_on_initializing=True))
        entry = 0
    dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    seeds = {p: i + 1 for i, p in enumerate(ASYNC_PARTIES)}
    delays = straggler_delays(ASYNC_ROUNDS, **straggler)
    serving = fed.serve(root, cfg, device=None if on_cuda else "cpu")
    state = {}
    if party != root:
        init_fn, step_fn = make_fed_train_step(cfg, dev, lr=1e-3)
        state["params"], state["opt"] = init_fn(0)
        data = synthetic_lm_dataset(cfg.vocab, batch * ASYNC_LOCAL_STEPS
                                    * (seq + 1), seq, seed=seeds[party])
        state["batches"] = make_batch_iterator(data, batch, dev)
    if party == "carol":
        # The joiner starts from the version it was admitted with.
        leaves, spec = tree_util.tree_flatten(state["params"])
        with torch.no_grad():
            for p, g in zip(leaves, tree_util.leaves_like(
                    bootstrap["params"], spec)):
                p.copy_(g)
        del bootstrap

    @fed.remote
    def current():
        return async_rounds.get_session().current()

    # A party's trainings run in round order, one at a time: each is a
    # pool task, and a later round's model may arrive first.
    turn = threading.Condition()
    mine = [q for q in range(ASYNC_ROUNDS) if party in _async_trainers(q)]
    state["trained"] = 0

    @fed.remote
    def train(model, r):
        """The party's local steps from the root's current model, after
        its earlier rounds' steps; bob sleeps by his straggler schedule
        first."""
        with turn:
            turn.wait_for(lambda: state["trained"] == mine.index(r))
        try:
            return _train(model, r)
        finally:
            with turn:
                state["trained"] += 1
                turn.notify_all()

    def _train(model, r):
        if party == "bob":
            time.sleep(delays[r])
            if r == straggler["stall_round"]:
                # However long carol's first training takes, bob's stalled
                # round lands after her offer, and so arrives stale.
                _wait_for(lambda: os.path.exists(
                    os.path.join(workdir, "carol-offered")),
                    "carol's offer", ASYNC_TIMEOUT_S / 4)
        if model["params"] is not None:
            leaves, spec = tree_util.tree_flatten(state["params"])
            with torch.no_grad():
                for p, g in zip(leaves, tree_util.leaves_like(
                        model["params"], spec)):
                    p.copy_(g)
        for _ in range(ASYNC_LOCAL_STEPS):
            inputs, targets = next(state["batches"])
            state["params"], state["opt"], loss = step_fn(
                state["params"], state["opt"], inputs, targets)
        state.setdefault("losses", []).append(float(loss))
        return state["params"]

    @fed.remote
    def cut(_after_training, step):
        """bob's cut at the same boundary: his model and AdamW state,
        saved, restored onto templates on his device, compared bitwise."""
        base = os.path.join(workdir, party)
        t = time.perf_counter()
        path = checkpoint.save_job_state(base, step=step,
                                         model=state["params"],
                                         opt_state=state["opt"])
        save_ms = 1e3 * (time.perf_counter() - t)
        group = state["opt"].param_groups[0]
        fresh = torch.optim.AdamW(
            [torch.zeros_like(p) for p in group["params"]], lr=group["lr"])
        t = time.perf_counter()
        got = checkpoint.restore_job_state(
            base, step=step, install=False,
            template={"model": state["params"], "opt_state": fresh})
        restore_ms = 1e3 * (time.perf_counter() - t)
        want_opt = state["opt"].state_dict()["state"]
        got_opt = got["opt_state"].state_dict()["state"]
        return dict(
            save_ms=save_ms, restore_ms=restore_ms, nbytes=_dir_bytes(path),
            model_bitwise=_bitwise_equal(got["model"], state["params"]),
            opt_bitwise=sorted(want_opt) == sorted(got_opt) and all(
                _bitwise_equal(got_opt[i], want_opt[i]) for i in want_opt),
            on_device=sorted({str(x.device) for x in
                              tree_util.tree_flatten(got["model"])[0]}))

    def own_report():
        return dict(
            launches=dict(fa.LAUNCHES), losses=state.get("losses", []),
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if on_cuda else None),
            spans=_push_spans())

    report = fed.remote(own_report)

    rec = dict(offers=[], versions={}, folds={}, rebuilt=None,
               rebuilt_versions={})
    rec_lock = threading.Lock()
    if party == root:
        agg = async_rounds._get_or_create_session(
            "default", AsyncAggregationConfig(buffer_k=ASYNC_K).as_dict(),
            serving.name)
        live_offer, live_fold = agg.offer, agg._fold_and_publish_locked
        live_publish = agg._publish_cb

        def fold(t0):
            rec["fold_start"] = timer.mark()
            return live_fold(t0)

        def publish(version, params):
            p0, h0 = timer.mark(), time.perf_counter()
            live_publish(version, params)
            rec["folds"][version] = dict(
                marks=(rec["fold_start"], p0, timer.mark()),
                publish_host_ms=1e3 * (time.perf_counter() - h0))
            rec["versions"][version] = params

        def offer(p, tree, *, round_tag, weight=1.0, epoch=None):
            with rec_lock:
                status = live_offer(p, tree, round_tag=round_tag,
                                    weight=weight, epoch=epoch)
                rec["offers"].append(dict(party=p, round_tag=round_tag,
                                          status=status,
                                          tree=_host_tree(tree)))
                if p == "carol":
                    open(os.path.join(workdir, "carol-offered"), "w").close()
                if rec["rebuilt"] is not None:
                    got = rec["rebuilt"].offer(p, tree, round_tag=round_tag,
                                               weight=weight, epoch=epoch)
                    if "published" in got:
                        rec["rebuilt_versions"][got["published"]] = \
                            rec["rebuilt"].current()["params"]
            return status

        agg.offer, agg._fold_and_publish_locked = offer, fold
        agg._publish_cb = publish

    def version():
        return async_rounds.get_session().current()["version"]

    def job_cut():
        """alice's cut of the job once version ASYNC_CUT_VERSION is out,
        and the aggregator rebuilt from it, under the offer lock so that
        no offer falls between the two."""
        base = os.path.join(workdir, root)
        with rec_lock:
            t = time.perf_counter()
            path = checkpoint.save_job_state(base, step=ASYNC_CUT_VERSION,
                                             model=agg.current()["params"])
            save_ms = 1e3 * (time.perf_counter() - t)
            t = time.perf_counter()
            got = checkpoint.restore_job_state(base, step=ASYNC_CUT_VERSION,
                                               install=False)
            restore_ms = 1e3 * (time.perf_counter() - t)
            saved = got["control"]["async_sessions"]["default"]
            rebuilt = async_rounds.BufferedAggregator(
                AsyncAggregationConfig(**saved["cfg"]),
                liveness_fn=liveness_view, session="rebuilt")
            rebuilt.adopt_state(saved)
            rec["rebuilt"] = rebuilt
        snap = got["control"]["membership"]
        return dict(nbytes=_dir_bytes(path), save_ms=save_ms,
                    restore_ms=restore_ms, buffered=len(saved["buffer"]),
                    round_tags=got["control"]["round_tags"],
                    membership_epoch=snap["view"]["epoch"],
                    roster=snap["view"]["roster"], version=saved["version"],
                    model_bitwise=_bitwise_equal(got["model"],
                                                 agg.current()["params"]))

    t_rounds = time.perf_counter()
    # carol leaves after her offer's round.
    last = ASYNC_CAROL_ROUND + 1 if party == "carol" else ASYNC_ROUNDS
    for r in range(entry, last):
        if party == root and r == ASYNC_JOIN_ROUND:
            _wait_for(lambda: version() >= 1, "version 1", ASYNC_TIMEOUT_S / 4)
            open(os.path.join(workdir, "v1"), "w").close()
            coord = get_membership_manager().get_coordinator_state()
            _wait_for(lambda: "carol" in coord.pending()["joins"],
                      "carol's join", ASYNC_TIMEOUT_S / 4)
        if party == root and r == ASYNC_CAROL_ROUND + 1:
            _wait_for(lambda: version() >= ASYNC_CUT_VERSION,
                      f"version {ASYNC_CUT_VERSION}", ASYNC_TIMEOUT_S / 4)
            out["cut"] = job_cut()
            coord = get_membership_manager().get_coordinator_state()
            _wait_for(lambda: "carol" in coord.pending()["leaves"],
                      "carol's leave", ASYNC_TIMEOUT_S / 4)
        if party == "carol" and r == entry:
            # The joiner holds the view of the sync that admitted it.
            view = fed.membership_view()
        else:
            view = fed.membership_sync(timeout=ASYNC_TIMEOUT_S / 2)
        out["views"].append([get_membership_manager().sync_index(),
                             view.epoch, list(view.roster)])
        trainers = _async_trainers(r)
        require(set(trainers) <= set(view.roster),
                f"round {r}: trainers {trainers} outside {view.roster}")
        model = current.party(root).remote()
        contribs = {p: train.party(p).remote(model, r) for p in trainers}
        handle = async_rounds.async_round(contribs, root=root, round_tag=r,
                                          publish_to=serving,
                                          fetch_model=False)
        if r == ASYNC_CAROL_ROUND:
            bob_cut = cut.party("bob").remote(contribs["bob"], r)
            out["carol_offer"], out["bob_cut"] = fed.get(
                [handle.offers["carol"], bob_cut])
    out["rounds_s"] = time.perf_counter() - t_rounds
    if party == "carol":
        out["report"] = own_report()
        t = time.perf_counter()
        fed.leave(timeout=ASYNC_TIMEOUT_S / 4)
        out["leave_ms"] = 1e3 * (time.perf_counter() - t)
        return out
    out["last_offer"] = fed.get(handle.offers["bob"])
    out["reports"] = dict(zip(ASYNC_PARTIES[:2], fed.get(
        [report.party(p).remote() for p in ASYNC_PARTIES[:2]])))
    if party == root:
        n_versions = (ASYNC_ROUNDS + 1) // ASYNC_K
        _wait_for(lambda: version() >= n_versions, f"version {n_versions}",
                  ASYNC_TIMEOUT_S / 4)
        out.update(_async_root_checks(rec, agg, cfg, dev, seq, timer, seeds))
        fed.get(serving.shutdown())
    else:
        fed.get(serving.shutdown())
    fed.shutdown()
    return out


def _async_root_checks(rec, agg, cfg, dev, seq, timer, seeds):
    """alice's checks at the end: every version against the CPU fold of
    the recorded offers, the rebuilt aggregator's versions against the
    live ones, the last version's loss against the initial params', and
    what the parent prints."""
    import numpy as np
    import torch

    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.serving import server as srv_mod

    accepted = [dict(party=o["party"], tree=o["tree"],
                     weight=o["status"]["weight"])
                for o in rec["offers"] if o["status"]["accepted"]]
    want = cpu_async_fold(accepted, ASYNC_K, agg.cfg.server_lr)
    live = [rec["versions"][v] for v in sorted(rec["versions"])]
    versions = []
    for v in sorted(rec["folds"]):
        marks = rec["folds"][v]["marks"]
        members = rec["offers"][(v - 1) * ASYNC_K:v * ASYNC_K]
        versions.append(dict(
            version=v, k=len(members),
            contributions=[dict(party=o["party"], round_tag=o["round_tag"],
                                staleness=o["status"]["staleness"],
                                weight=o["status"]["weight"])
                           for o in members],
            fold_ms=timer.ms(marks[0], marks[1]),
            publish_ms=timer.ms(marks[1], marks[2]),
            publish_host_ms=rec["folds"][v]["publish_host_ms"]))

    blk = torch.as_tensor(np.stack([next(synthetic_lm_dataset(
        cfg.vocab, 2 * (seq + 1), seq, seed=seeds[p]).batches(1, epoch=0))[0]
        for p in ASYNC_PARTIES[1:]]), device=dev).long()

    def loss(params):
        with torch.no_grad():
            return float(tfm.lm_loss_pair(params, blk[:, :-1], blk[:, 1:],
                                          cfg, fa.make_flash_attn_fn(),
                                          loss_chunk=512))

    return dict(
        versions=versions, n_offers=len(rec["offers"]),
        cpu_fold_bitwise=[_bitwise_equal(a, b) for a, b in zip(live, want)],
        n_cpu_versions=len(want),
        rebuilt_bitwise={v: _bitwise_equal(t, rec["versions"][v])
                         for v, t in rec["rebuilt_versions"].items()},
        losses=[loss(tfm.init_params(0, cfg, dev)), loss(live[-1])],
        publishes=agg.snapshot_stats()["publishes"],
        version_digests={v: _tree_digest(t)
                         for v, t in rec["versions"].items()},
        bank_version=srv_mod.get_server().bank.current_version())


def phase_async(device, cfg, *, batch, seq, label="",
                straggler=ASYNC_STRAGGLER, timeout_s=ASYNC_TIMEOUT_S):
    """Phase 8: :func:`_async_program` in three spawned party processes
    (carol joins mid-job), checked: (a) every version alice published
    equals the CPU fold of the recorded offers bitwise, (b) the aggregator
    rebuilt from alice's job cut publishes the live session's next
    version bitwise, (c) every party saw the same view at each sync,
    carol's join and leave landed as epoch bumps, and her join's bootstrap
    is the bits of the bank's version it names, (d) a contribution
    arrived stale, (e) the last version's loss is below the initial
    params', (f) the cuts restore bitwise (bob's model and AdamW state on
    his device), (g) every version reached the serving bank, (h) each
    trainer launched every bf16 kernel on a card; every party exits 0
    (``spawn_parties``). Returns the parties' results."""
    import dataclasses

    import torch

    t8 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        results, wall = spawn_parties(
            _async_program, (device, dataclasses.asdict(cfg), batch, seq,
                             workdir, dict(straggler)),
            timeout_s, names=ASYNC_PARTIES)
    res = results["alice"]
    require(len(res["cpu_fold_bitwise"]) == res["n_cpu_versions"] >= 3
            and all(res["cpu_fold_bitwise"]),
            f"(a) the published versions against the CPU fold: "
            f"{res['cpu_fold_bitwise']} ({res['n_cpu_versions']} folded)")
    require(res["rebuilt_bitwise"] and all(res["rebuilt_bitwise"].values()),
            f"(b) the rebuilt aggregator's versions: {res['rebuilt_bitwise']}")
    views = {}
    for p, r in results.items():
        for idx, epoch, roster in r["views"]:
            views.setdefault(idx, {})[p] = (epoch, tuple(roster))
    for idx, seen in sorted(views.items()):
        require(len(set(seen.values())) == 1,
                f"(c) the parties saw different views at sync {idx}: {seen}")
    rosters = [next(iter(seen.values())) for _, seen in sorted(views.items())]
    require(rosters[0][1] == ("alice", "bob")
            and ("alice", "bob", "carol") in [ro for _, ro in rosters]
            and rosters[-1][1] == ("alice", "bob") and rosters[-1][0] >= 2,
            f"(c) carol's join and leave as epoch bumps: {rosters}")
    stale = [c for v in res["versions"] for c in v["contributions"]
             if c["staleness"] >= 1]
    boot = results["carol"]["bootstrap"]
    require(boot["digest"] == res["version_digests"][str(boot["version"])],
            f"(c) carol's bootstrap is not version {boot['version']}'s bits")
    require(stale, f"(d) no stale contribution: {res['versions']}")
    require(res["losses"][1] < res["losses"][0],
            f"(e) the loss did not fall: {res['losses']}")
    bob_cut = results["bob"]["bob_cut"]
    require(bob_cut["model_bitwise"] and bob_cut["opt_bitwise"]
            and res["cut"]["model_bitwise"],
            f"(f) the cuts' round trips: bob {bob_cut}, alice {res['cut']}")
    require(res["bank_version"] == res["publishes"] == len(res["versions"]),
            f"(g) bank at version {res['bank_version']} after "
            f"{res['publishes']} publishes")
    reports = dict(res["reports"], carol=results["carol"]["report"])
    if torch.device(device).type == "cuda":
        for p in ASYNC_PARTIES[1:]:
            for k in BF16_KERNELS:
                require(reports[p]["launches"][k] > 0,
                        f"(h) {p} did not launch {k}: "
                        f"{reports[p]['launches']}")
    for v in res["versions"]:
        print(f"[async] {label} version {v['version']}: k={v['k']}, "
              + ", ".join(f"{c['party']} tag {c['round_tag']} staleness "
                          f"{c['staleness']} weight {c['weight']:.6f}"
                          for c in v["contributions"])
              + f"; fold {v['fold_ms']:.3f} ms, publish "
              f"{v['publish_ms']:.3f} ms ({v['publish_host_ms']:.3f} ms on "
              f"the host)")
    for p in pushes(reports):
        if p["dst"] == "alice" and p["src"] != "alice":
            print(f"[async] {label} offer push {p['src']} -> alice "
                  f"{p['nbytes']} B: {p['total_ms']:.1f} ms (" + ", ".join(
                      f"{k} " + ("-" if p[f"{k}_ms"] is None
                                 else f"{p[f'{k}_ms']:.1f}")
                      for k in PUSH_KINDS) + ")")
    cut = res["cut"]
    print(f"[async] {label} carol: join {results['carol']['join_ms']:.1f} ms"
          f" (bootstrap: the bank's version {boot['version']}),"
          f" leave {results['carol']['leave_ms']:.1f} ms; (epoch, roster) "
          f"at each sync {rosters}")
    print(f"[async] {label} alice's cut: {cut['nbytes']} B, save "
          f"{cut['save_ms']:.1f} ms, restore {cut['restore_ms']:.1f} ms "
          f"({cut['buffered']} buffered, round tags {cut['round_tags']}, "
          f"membership epoch {cut['membership_epoch']}); bob's cut (model + "
          f"AdamW): {bob_cut['nbytes']} B, save {bob_cut['save_ms']:.1f} ms,"
          f" restore {bob_cut['restore_ms']:.1f} ms onto "
          f"{bob_cut['on_device']}")
    print(f"[async] {label} loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][1]:.4f}; {res['n_offers']} offers, "
          f"{res['publishes']} publishes; peak memory "
          + ", ".join(f"{p} {rep['max_memory_allocated']}"
                      for p, rep in reports.items())
          + f"; phase 8 {time.perf_counter() - t8:.1f} s ({wall:.1f} s from "
          f"spawn to exit)")
    return results


# ---------------------------------------------------------------------------
# Phase 9: the rest of the transformer family (MoE, remat="attn", LoRA)
# ---------------------------------------------------------------------------

# The repo has no MoE configuration of its own: phase 9's MoE model is the
# flagship width with each dense FFN replaced by a top-1 MoE FFN of
# FAMILY_EXPERTS experts, each d_ff wide (an assumption, no source).
FAMILY_EXPERTS = 8
# MoE train steps under remat="attn", and under remat False and True for
# the comparison; the first step of each warms up and is not timed.
FAMILY_STEPS = 3
FAMILY_MODE_STEPS = 2
REMAT_MODES = ("attn", False, True)
# The remat agreement check runs at this smaller (depth, batch). K1-K3
# have no atomics and every other op runs at the same shapes in each mode,
# so the three modes' loss and gradients are held bitwise.
FAMILY_REMAT_CHECK = (2, 2)
# The LoRA FedAvg round: examples/fedavg_lora.py at the flagship width,
# with the example's adapters (its RANK on the attention targets) and its
# LOCAL_STEPS; one round: a second repeats the first's checks.
FAMILY_LORA_ROUNDS = 1
# Phase 9 (b)'s join deadline (phase 9: 33.0 s).
FAMILY_LORA_TIMEOUT_S = 90
# The MoE decode check: f32 compute at depth 2 (as phase 7's (d)), cached
# prefill and decode logits within SERVE_LOGIT_TOL of a full forward's
# norm; then greedy tokens from the bf16 MoE model of (a).
FAMILY_DECODE_LAYERS = 2
FAMILY_DECODE_PROMPT = 48
FAMILY_DECODE_NEW = 8
# Sampled decoding of the bf16 MoE model: jax.random.categorical's tokens
# from a threefry key, truncated to the top FAMILY_SAMPLE_TOP_K.
FAMILY_SAMPLE_TEMPERATURE = 0.8
FAMILY_SAMPLE_TOP_K = 40


def moe_steps(cfg, device, *, batch, seq, remat, steps, lr=1e-3, seed=0):
    """``steps`` AdamW steps of ``make_fed_train_step(attn="flash",
    remat=remat)`` on ``cfg`` from ``seed``: the losses, each step's ms
    (host clock around the synchronized step), the kernel launches, the
    peak memory (params, AdamW state and activations) and the state."""
    import torch

    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    on_cuda = torch.device(device).type == "cuda"
    init_fn, step_fn = make_fed_train_step(cfg, device, lr=lr, attn="flash",
                                           remat=remat)
    params, opt = init_fn(seed)
    # The same batches in every mode: the first ``steps`` of FAMILY_STEPS.
    data = synthetic_lm_dataset(
        cfg.vocab, batch * max(steps, FAMILY_STEPS) * (seq + 1), seq,
        seed=seed + 1)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, step_ms = [], []
    for _, blk in zip(range(steps), data.batches(batch, epoch=0)):
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        losses.append(float(loss))
        if on_cuda:
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    timed = step_ms[1:] or step_ms
    return dict(
        losses=losses, step_ms=step_ms,
        tokens_per_s=len(timed) * batch * seq / sum(timed) * 1e3,
        launches=dict(fa.LAUNCHES),
        k1_per_step=fa.LAUNCHES["flash_fwd"] / len(losses),
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if on_cuda else None),
        params=params)


def remat_agreement(cfg, device, *, seq, seed=5):
    """One loss and gradient of ``cfg`` at ``FAMILY_REMAT_CHECK``'s depth
    and batch under each remat mode, with the flash kernels: the elements
    of the loss and gradients that differ from ``remat=False``'s, and the
    largest difference relative to the gradient's largest entry."""
    import dataclasses

    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa

    depth, batch = FAMILY_REMAT_CHECK
    small = dataclasses.replace(cfg, n_layers=depth)
    base = tfm.init_params(seed, small, device)
    gen = torch.Generator(device=base["embed"].device).manual_seed(seed)
    blk = torch.randint(0, small.vocab, (batch, seq + 1), generator=gen,
                        device=base["embed"].device)
    got = {}
    for mode in REMAT_MODES:
        ps = tree_util.tree_map(
            lambda p: p.detach().clone().requires_grad_(True), base)
        loss = tfm.lm_loss_pair(ps, blk[:, :-1], blk[:, 1:], small,
                                fa.make_flash_attn_fn(), remat=mode,
                                loss_chunk=512)
        loss.backward()
        got[mode] = [loss.detach()] + [p.grad for p in
                                       tree_util.tree_flatten(ps)[0]]
    out = {}
    for mode in (True, "attn"):
        diff = sum(int((_int_view(a) != _int_view(b)).sum())
                   for a, b in zip(got[mode], got[False]))
        rel = max(float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30)
                  for a, b in zip(got[mode], got[False]))
        out[str(mode)] = dict(mismatched=diff, max_rel=rel)
    out["elements"] = sum(x.numel() for x in got[False])
    return out


def moe_decode_check(cfg, device, params, *, seed=9):
    """(c): cached decode of the MoE model. At f32 compute and
    ``FAMILY_DECODE_LAYERS`` layers (fresh params), the prefill's and each
    decode step's logits against a full forward over the same tokens
    (error norm over the reference's norm, per position block); then
    ``FAMILY_DECODE_NEW`` greedy tokens from ``params`` (the bf16 model of
    (a)), twice, through ``make_generate_fn``; then as many sampled ones
    (``FAMILY_SAMPLE_TEMPERATURE``, top ``FAMILY_SAMPLE_TOP_K``) from one
    threefry key, twice, each checked against the top-k of the logits a
    replay of the same cached decode gives at its position, and the
    key's threefry ``uniform`` and ``gumbel`` words on the card against
    the CPU's."""
    import dataclasses

    import torch

    from rayfed_tpu_torch.models import decode, transformer as tfm

    f32 = dataclasses.replace(cfg, n_layers=FAMILY_DECODE_LAYERS,
                              compute_dtype=torch.float32)
    p32 = tfm.init_params(seed, f32, device)
    dev = p32["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(1, cfg.vocab, (1, FAMILY_DECODE_PROMPT),
                           generator=gen, device=dev)
    s, new = FAMILY_DECODE_PROMPT, FAMILY_DECODE_NEW
    with torch.no_grad():
        cache = decode.init_cache(f32, 1, s + new, device=dev)
        logits, cache = decode.forward_with_cache(p32, prompt, cache, 0, f32)
        cached = [logits[0]]
        toks = [int(logits[0, -1].argmax())]
        for pos in range(s, s + new - 1):
            step, cache = decode.forward_with_cache(
                p32, torch.tensor([[toks[-1]]], device=dev), cache, pos, f32)
            cached.append(step[0])
            toks.append(int(step[0, -1].argmax()))
        seq = torch.cat([prompt, torch.tensor([toks], device=dev)], dim=1)
        full = tfm.forward(p32, seq[:, :-1], f32)[0]
        cached = torch.cat(cached, dim=0)
        ratios = {"prefill": float((cached[:s] - full[:s]).norm()
                                   / full[:s].norm()),
                  "decode": float((cached[s:] - full[s:]).norm()
                                  / full[s:].norm())}
        gen_fn = decode.make_generate_fn(f32, max_new_tokens=new)
        same_as_loop = gen_fn(p32, prompt)[0, s:].tolist() == toks
        bf16_fn = decode.make_generate_fn(cfg, max_new_tokens=new)
        first = bf16_fn(params, prompt)
        again = bf16_fn(params, prompt)
        sampled = sampled_decode_check(cfg, params, prompt, seed=seed)
    greedy = first[0, s:].tolist()
    return dict(ratios=ratios, f32_tokens=toks, same_as_loop=same_as_loop,
                greedy=greedy, rerun_equal=torch.equal(first, again),
                in_vocab=all(0 <= t < cfg.vocab for t in greedy),
                sampled=sampled)


def sampled_decode_check(cfg, params, prompt, *, seed):
    """Sampled decoding through ``make_generate_fn`` from the threefry key
    ``prng_key(seed)``: the tokens of two calls, whether each lies in the
    top ``FAMILY_SAMPLE_TOP_K`` of the logits that a replay of the same
    cached decode gives at its position, the ms of one call, and the
    key's ``uniform`` and ``gumbel`` words over one row of the vocab on
    the card against the CPU's, bitwise."""
    import torch

    from rayfed_tpu_torch.models import decode
    from rayfed_tpu_torch.privacy import threefry

    dev = prompt.device
    s, new, top_k = prompt.shape[1], FAMILY_DECODE_NEW, FAMILY_SAMPLE_TOP_K
    fn = decode.make_generate_fn(cfg, max_new_tokens=new,
                                 temperature=FAMILY_SAMPLE_TEMPERATURE,
                                 top_k=top_k)
    key = threefry.prng_key(seed)
    t = time.perf_counter()
    first = fn(params, prompt, key)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    call_ms = 1e3 * (time.perf_counter() - t)
    again = fn(params, prompt, key)
    toks = first[0, s:].tolist()
    inv_t = decode._reciprocal(FAMILY_SAMPLE_TEMPERATURE)
    cache = decode.init_cache(cfg, 1, s + new - 1, device=dev)
    logits, cache = decode.prefill(params, prompt, cache, cfg)
    in_top_k = []
    for i, tok in enumerate(toks):
        scaled = logits[0] * inv_t
        kth = torch.sort(scaled).values[-top_k]
        in_top_k.append(bool(scaled[tok] >= kth))
        if i < new - 1:
            step, cache = decode.forward_with_cache(
                params, torch.tensor([[tok]], device=dev), cache, s + i, cfg)
            logits = step[:, -1]
    sub = threefry.split(key)[1]
    words_equal = {}
    for name, fn_ in (("uniform", threefry.uniform),
                      ("gumbel", threefry.gumbel)):
        card = fn_(sub, (1, cfg.vocab), device=dev).cpu()
        words_equal[name] = torch.equal(card.view(torch.int32),
                                        fn_(sub, (1, cfg.vocab)).view(
                                            torch.int32))
    return dict(tokens=toks, same_key_equal=torch.equal(first, again),
                in_top_k=in_top_k, call_ms=call_ms, words_equal=words_equal)


def _lora_program(party, addresses, device, cfg_kw, batch, seq, rounds, lr):
    """Phase 9 (b)'s party: ``rayfed_tpu_torch/examples/fedavg_lora.py``
    (its ``LoraWorker`` and ``run``) at ``cfg_kw``'s width with
    ``transport="cuda"`` on a card ("tcp" on the CPU), plus what the parent
    checks: each round's aggregate at the root against the CPU fold of
    the two pushed adapter trees, both parties' merged-model and base
    digests, each round's wall, each party's launches and peak memory."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh, topology, tree_util
    from rayfed_tpu_torch.examples import fedavg_lora as example
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import reduce_by_plan

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    names = list(example.SEEDS)
    root, other = names
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp",
             config={"cross_silo_comm": FED_COMM})
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()

    @fed.remote
    def check_fold(mine, theirs, agg):
        """At the root: the aggregate on the party's device against the
        CPU fold (``reduce_by_plan``, the sum and divide of
        ``fed_aggregate``) of the two pushed adapter trees."""
        want = reduce_by_plan(topology.plan(names, "flat"),
                              {root: _host_tree(mine),
                               other: _host_tree(theirs)})
        got, spec = tree_util.tree_flatten(_host_tree(agg))
        mismatched = sum(int((_int_view(a) != _int_view(b)).sum())
                         for a, b in zip(got, tree_util.leaves_like(want,
                                                                    spec)))
        return dict(mismatched=mismatched,
                    elements=sum(x.numel() for x in got),
                    adapter_bytes=_tree_nbytes(agg),
                    landed=sorted({str(x.device) for x in
                                   tree_util.tree_flatten(theirs)[0]}),
                    folded_on=sorted({str(x.device) for x in
                                      tree_util.tree_flatten(agg)[0]}))

    @fed.remote
    def report():
        return dict(launches=dict(fa.LAUNCHES),
                    max_memory_allocated=(torch.cuda.max_memory_allocated()
                                          if on_cuda else None))

    workers = {n: example.LoraWorker.party(n).remote(
        seed, cfg, batch=batch, seq=seq, lr=lr,
        device=None if on_cuda else "cpu")
        for n, seed in example.SEEDS.items()}
    start = fed.get([workers[n].digests.remote() for n in names])
    rounds_out = []
    t0 = [time.perf_counter()]

    def on_round(r, locals_, g, reports):
        wall = time.perf_counter() - t0[0]
        chk = fed.get(check_fold.party(root).remote(locals_[root],
                                                    locals_[other], g))
        digests = fed.get([workers[n].digests.remote(g) for n in names])
        rounds_out.append(dict(wall_s=wall, check=chk, digests=digests,
                               losses=[rep[0] for rep in reports]))
        t0[0] = time.perf_counter()

    example.run(party, workers, rounds=rounds, on_round=on_round)
    end = fed.get([workers[n].digests.remote() for n in names])
    reports = fed.get([report.party(n).remote() for n in names])
    fed.shutdown()
    return dict(party=party, rounds=rounds_out, start=start, end=end,
                reports=dict(zip(names, reports)))


def phase_lora(device, cfg, *, batch, seq, rounds=FAMILY_LORA_ROUNDS,
               lr=1e-3, label="", timeout_s=FAMILY_LORA_TIMEOUT_S):
    """Phase 9 (b): the LoRA FedAvg program in two spawned party processes,
    checked: (b1) both parties' merged models hash the same every round,
    (b2) the root's aggregate is bitwise the CPU fold of the two pushed
    adapter trees, landed on and folded on the root's device, (b3) the
    frozen base hashes the same before and after the rounds, in both
    parties, (b4) each party's local steps launched K1-K3 (on a card)."""
    import dataclasses

    import torch

    from rayfed_tpu_torch.examples import fedavg_lora as example

    on_cuda = torch.device(device).type == "cuda"
    results, wall = spawn_parties(
        _lora_program, (device, dataclasses.asdict(cfg), batch, seq, rounds,
                        lr), timeout_s)
    root, other = (n for n, _ in PARTIES)
    res = results[root]
    require(all(results[other][k] == res[k]
                for k in ("start", "end", "reports")),
            "the parties disagree on values both fetched through fed.get")
    for r, rnd in enumerate(res["rounds"]):
        merged = {d["merged"] for d in rnd["digests"]}
        require(len(merged) == 1,
                f"(b1) round {r}: the merged models hash differently")
        chk = rnd["check"]
        require(chk["mismatched"] == 0,
                f"(b2) round {r}: the aggregate differs from the CPU fold in "
                f"{chk['mismatched']} of {chk['elements']} elements")
        devs = {chk["landed"][0], chk["folded_on"][0]}
        require(len(chk["landed"]) == len(chk["folded_on"]) == 1
                and len(devs) == 1,
                f"(b2) round {r}: landed on {chk['landed']}, folded on "
                f"{chk['folded_on']}")
    bases = {d["base"] for d in res["start"] + res["end"]}
    require(len(bases) == 1,
            "(b3) the frozen base changed over the rounds or differs "
            "between the parties")
    if on_cuda:
        for n, rep in res["reports"].items():
            require(all(rep["launches"][k] > 0 for k in BF16_KERNELS),
                    f"(b4) party {n}'s LoRA steps did not launch every "
                    f"kernel: {rep['launches']}")
    adapter = res["rounds"][0]["check"]["adapter_bytes"]
    base = res["start"][0]["base_bytes"]
    print(f"[family] {label} LoRA FedAvg (rank {example.RANK}, "
          f"attention targets): two party processes, {rounds} rounds of "
          f"{example.LOCAL_STEPS} steps at batch {batch} in {wall:.1f} s from spawn "
          f"to exit; round walls "
          + ", ".join(f"{rnd['wall_s']:.2f} s" for rnd in res["rounds"])
          + f"; adapter push {adapter} B a round against base "
          f"{base} B ({base / adapter:.0f}x smaller)")
    print(f"[family] {label} LoRA local losses per round "
          + str([rnd["losses"] for rnd in res["rounds"]])
          + "; merged digests equal, folds bitwise "
          f"({res['rounds'][0]['check']['elements']} elements), base "
          "unchanged")
    for n, rep in res["reports"].items():
        print(f"[family] {label} LoRA party {n}: launches {rep['launches']}, "
              f"max_memory_allocated {rep['max_memory_allocated']}")
    return dict(results=results, wall_s=wall, adapter_bytes=adapter,
                base_bytes=base)


def phase_family(device, cfg, *, batch, seq, label="", steps=FAMILY_STEPS,
                 mode_steps=FAMILY_MODE_STEPS,
                 lora_timeout_s=FAMILY_LORA_TIMEOUT_S, lora_cfg=None):
    """Phase 9: (a) the MoE model (``cfg`` with ``FAMILY_EXPERTS``
    experts) trained under ``remat="attn"`` and, for the comparison, under
    ``remat=False`` and ``True``; the three modes' loss and gradients
    bitwise equal at ``FAMILY_REMAT_CHECK``; (c) MoE cached decode; (b)
    the LoRA FedAvg round on the dense ``lora_cfg`` (default ``cfg``).
    Returns a summary with the MoE steps' launches (``launches``,
    remat="attn")."""
    import dataclasses
    import gc

    import torch

    on_cuda = torch.device(device).type == "cuda"
    moe_cfg = dataclasses.replace(cfg, n_experts=FAMILY_EXPERTS)
    modes, launches, state = {}, None, None
    for mode in REMAT_MODES:
        run = moe_steps(moe_cfg, device, batch=batch, seq=seq, remat=mode,
                        steps=steps if mode == "attn" else mode_steps)
        require(all(x == x and abs(x) < 1e30 for x in run["losses"]),
                f"(a) remat={mode!r}: non-finite loss {run['losses']}")
        if mode == "attn":
            launches, state = run["launches"], run.pop("params")
            if on_cuda:
                require(all(launches[k] > 0 for k in BF16_KERNELS),
                        f"(a) the MoE steps did not launch every kernel: "
                        f"{launches}")
        run.pop("params", None)
        modes[mode] = run
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
    for mode, run in modes.items():
        print(f"[family] {label} MoE ({FAMILY_EXPERTS} experts, top-1) "
              f"remat={mode!r}: losses {[round(x, 4) for x in run['losses']]}"
              f", step ms {[round(x, 1) for x in run['step_ms']]} "
              f"({run['tokens_per_s']:.1f} tokens/s after the first), "
              f"max_memory_allocated {run['max_memory_allocated']}, K1 "
              f"launches per step {run['k1_per_step']:g}, launches "
              f"{run['launches']}")
    agree = remat_agreement(moe_cfg, device, seq=seq)
    for mode in ("True", "attn"):
        require(agree[mode]["mismatched"] == 0,
                f"(a) remat={mode} differs from remat=False in "
                f"{agree[mode]['mismatched']} of {agree['elements']} loss "
                f"and gradient elements (largest relative difference "
                f"{agree[mode]['max_rel']:.3g})")
    print(f"[family] {label} remat True and 'attn' vs False at depth "
          f"{FAMILY_REMAT_CHECK[0]}, batch {FAMILY_REMAT_CHECK[1]}: loss and "
          f"gradients bitwise equal ({agree['elements']} elements)")
    dec = moe_decode_check(moe_cfg, device, state)
    require(all(r <= SERVE_LOGIT_TOL for r in dec["ratios"].values()),
            f"(c) cached MoE logits vs the full forward: {dec['ratios']}")
    require(dec["same_as_loop"] and dec["rerun_equal"] and dec["in_vocab"],
            f"(c) greedy MoE decoding: {dec}")
    smp = dec["sampled"]
    require(smp["same_key_equal"] and all(smp["in_top_k"])
            and all(smp["words_equal"].values()),
            f"(c) sampled MoE decoding: {smp}")
    print(f"[family] {label} MoE decode: f32 cached vs full forward "
          f"{dec['ratios']} (limit {SERVE_LOGIT_TOL}); greedy bf16 tokens "
          f"{dec['greedy']}; sampled (temperature "
          f"{FAMILY_SAMPLE_TEMPERATURE}, top_k {FAMILY_SAMPLE_TOP_K}, one "
          f"threefry key) {smp['tokens']}, the same on a rerun, each in the "
          f"top-k of its replayed logits, {smp['call_ms']:.1f} ms a call; "
          f"threefry words on the card equal the CPU's: "
          f"{smp['words_equal']}")
    del state
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    lora_out = phase_lora(device, lora_cfg or cfg, batch=batch, seq=seq,
                          label=label,
                          timeout_s=lora_timeout_s)
    return dict(modes=modes, launches=launches, agree=agree, decode=dec,
                lora=lora_out)


# ---------------------------------------------------------------------------
# Phase 10: secure aggregation (the privacy plane)
# ---------------------------------------------------------------------------

# The secure job: three parties on the card, alice the root; each takes
# one bf16 local step at PRIVACY_BATCH (a cut of the flagship batch: the
# three parties' train steps share the card) and offers its params.
PRIVACY_PARTIES = ("alice", "bob", "carol")
PRIVACY_BATCH = 4
PRIVACY_MASK_SEED = 1234
PRIVACY_FP_BITS = 16  # privacy.fixedpoint_bits (the default)
# Check (a): the mask words at the first and last this many flat indices
# of the largest leaf, the card's against the CPU's.
PRIVACY_CHECK_WORDS = 1 << 20
# Check (c): |secure - plaintext tree_mean| per entry within half a grid
# step, 2**-(f+1) (each party's encoding rounds by at most that; the mean
# of three such errors is no larger), plus the f32 roundings of the two
# paths at the entry: the decoded sum's cast and the division, the
# plaintext fold's two sums and reciprocal product, within eight f32
# epsilons of the entries' mean magnitude.
PRIVACY_MEAN_ULPS = 8 * 2.0 ** -23
# Phase 10's join deadline (phase 10: 90.7 s).
PRIVACY_TIMEOUT_S = 240
PRIVACY_DROPOUT_DOMAIN = "smoke-dropout"
# The DP job (checks (g)-(i)), in the same three processes after the
# secure one: each party clips its update to DP_CLIP_FRACTION of the
# initial tree's norm (about 405 at this width and depth; a few steps
# move it little, so the clip acts), the root adds noise of stddev
# noise_multiplier * clip / 3 and charges each party
# sqrt(2 ln(1.25 / delta)) / noise_multiplier a round; plaintext pushes
# ride the int8 wire tier.
DP_JOB = "smoke-dp"
DP_STEPS = 2
DP_DELTA = 1e-5
DP_CLIP_FRACTION = 0.25
DP_PRIVACY = {"secure_aggregation": True, "mask_seed": PRIVACY_MASK_SEED,
              "fixedpoint_bits": PRIVACY_FP_BITS, "noise_multiplier": 1.1,
              "noise_seed": 2026, "delta": DP_DELTA, "quantize": "int8"}
# (h): the mean of noise / stddev over every entry within this many
# standard errors of 0, and its standard deviation within as many of 1.
DP_MOMENT_SE = 5.0


def _grid(tree, fp_bits):
    """``tree`` rounded to integer multiples of 2**-fp_bits of magnitude
    at most 16: the sum of three such values is exact in f32, so a secure
    mean of such trees is the plaintext fold's bit for bit. Zeros are
    +0.0 (a ring sum of zeros decodes to +0.0, where a float sum of -0.0
    stays -0.0)."""
    import torch

    from rayfed_tpu_torch import tree_util

    scale = float(1 << fp_bits)
    lim = float(1 << (fp_bits + 4))

    def leaf(x):
        q = torch.round(x.detach() * scale).clamp_(-lim, lim)
        return torch.where(q == 0, torch.zeros_like(q), q) / scale

    return tree_util.tree_map(leaf, tree)


def _privacy_program(party, addresses, device, cfg_kw, batch, seq,
                     dp_addresses, dp_privacy):
    """Phase 10's driver, the same program in every party: one bf16 local
    step, then secure rounds at alice over the parties' params: (1) a
    plaintext and a secure ``fed_aggregate`` mean of the trained trees,
    (2) both again over grid-valued copies, (3) a secure round over the
    grid trees whose carol envelope is withheld, recovered from alice's
    and bob's ``reoffer_seeds``, against the plaintext mean of the
    survivors, (4) one secure ``async_round`` at ``buffer_k`` 2. Each
    party times its encode and each partner's mask stream, and keeps the
    largest leaf's encoded and masked words at both ends for check (a);
    alice times the ring sum and decode and keeps the first round's
    masked sum for check (b). Then the same processes run the DP job
    (:func:`_dp_job`) on ``dp_addresses``."""
    import gc

    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import async_rounds, mesh
    from rayfed_tpu_torch.data import make_batch_iterator, synthetic_lm_dataset
    from rayfed_tpu_torch.federated import (
        _secagg_mask,
        _secagg_reduce,
        fed_aggregate,
    )
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.privacy import secagg, threefry
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    root = PRIVACY_PARTIES[0]
    timer = _DeviceTimer(on_cuda)
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp",
             config={"cross_silo_comm": FED_COMM,
                     "barrier_on_initializing": True,
                     "privacy": {"secure_aggregation": True,
                                 "mask_seed": PRIVACY_MASK_SEED,
                                 "fixedpoint_bits": PRIVACY_FP_BITS}})
    dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    mgr = get_privacy_manager()
    out = dict(party=party)

    fa.reset_launch_counts()
    init_fn, step_fn = make_fed_train_step(cfg, dev, lr=1e-3)
    params, opt = init_fn(0)
    seeds = {p: i + 1 for i, p in enumerate(PRIVACY_PARTIES)}
    data = synthetic_lm_dataset(cfg.vocab, batch * (seq + 1), seq,
                                seed=seeds[party])
    inputs, targets = next(make_batch_iterator(data, batch, dev))
    params, opt, loss = step_fn(params, opt, inputs, targets)
    out["loss"] = float(loss)
    out["launches"] = dict(fa.LAUNCHES)
    del opt, inputs, targets, step_fn
    gc.collect()
    if on_cuda:
        out["step_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = {"params": params, "grid": _grid(params, PRIVACY_FP_BITS)}

    # Timing and capture around the privacy plane's own functions.
    others = [p for p in PRIVACY_PARTIES if p != party]
    seed_owner = {mgr._generate_seed(q): q for q in others}
    rec = dict(encode=[], streams={}, sums=[], decodes=[])
    live = dict(encode=secagg.encode_tree, acc=secagg._accumulate,
                modsum=secagg.modular_sum_host, decode=secagg.decode_sum,
                mask=mgr.mask_contribution)
    n_check = PRIVACY_CHECK_WORDS

    def ends(words):
        flat = words.reshape(-1)
        k = min(n_check, flat.numel())
        return (flat[:k].to(torch.int64).clone(),
                flat[-k:].to(torch.int64).clone())

    def encode_tree(tree, fp, n):
        a = timer.mark()
        ring, dtypes, spec = live["encode"](tree, fp, n)
        rec["encode"].append((a, timer.mark()))
        if "a_enc" not in rec:
            idx = max(range(len(ring)), key=lambda i: (ring[i].numel(), -i))
            rec["a_idx"], rec["a_numel"] = idx, ring[idx].numel()
            rec["a_enc"] = ends(ring[idx])
        return ring, dtypes, spec

    def accumulate(acc, pair_seed, domain, round_index, leaf_index, sign):
        a = timer.mark()
        live["acc"](acc, pair_seed, domain, round_index, leaf_index, sign)
        key = (domain, round_index, seed_owner.get(pair_seed, "?"))
        rec["streams"].setdefault(key, []).append((a, timer.mark(),
                                                   acc.numel()))

    def modular_sum(contributions):
        a = timer.mark()
        words = live["modsum"](contributions)
        rec["sums"].append((a, timer.mark()))
        if "b_sum" not in rec:
            rec["b_sum"] = words
        return words

    def decode_sum(words, dtypes, spec, fp):
        a = timer.mark()
        tree = live["decode"](words, dtypes, spec, fp)
        rec["decodes"].append((a, timer.mark()))
        return tree

    def mask_contribution(tree, **kw):
        env = live["mask"](tree, **kw)
        if "a_masked" not in rec:
            rec["a_round"] = (kw["domain"], kw["round_index"])
            rec["a_masked"] = ends(secagg._leaves(env["q"])[0][rec["a_idx"]])
        return env

    secagg.encode_tree, secagg._accumulate = encode_tree, accumulate
    secagg.modular_sum_host, secagg.decode_sum = modular_sum, decode_sum
    mgr.mask_contribution = mask_contribution

    @fed.remote
    def get_tree(kind):
        return state[kind]

    @fed.remote
    def stamp(_agg):
        if on_cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    @fed.remote
    def same(a, b):
        return _bitwise_equal(a, b)

    @fed.remote
    def withheld(_tree):
        return None  # carol's envelope never leaves carol

    @fed.remote
    def reoffer(dead):
        mgr.reoffer_seeds(dead, root=root)
        return True

    @fed.remote
    def check_round(sec, *trees):
        """(b) the ring sum of the three masked envelopes (kept by the
        secure round) against the ring sum of the three trees' plain
        encodings; (c) the secure mean against ``tree_mean``."""
        masked_sum = rec.pop("b_sum")
        per_party = [secagg._leaves(t)[0] for t in trees]
        sec_leaves = secagg._leaves(sec)[0]
        b_ok, c_err, c_ratio = True, 0.0, 0.0
        eps = 2.0 ** -(PRIVACY_FP_BITS + 1)
        for idx, want in enumerate(masked_sum):
            xs = [leaves[idx].detach() for leaves in per_party]
            plain_sum = None
            for x in xs:
                words = live["encode"](x, PRIVACY_FP_BITS, len(xs))[0][0]
                plain_sum = (words if plain_sum is None
                             else (plain_sum + words) & 0xFFFFFFFF)
                del words
            b_ok = b_ok and torch.equal(plain_sum, want)
            del plain_sum
            plain = tree_mean(*xs)
            diff = (sec_leaves[idx].double() - plain.double()).abs()
            mag = sum(x.double().abs() for x in xs) / len(xs)
            bound = eps + PRIVACY_MEAN_ULPS * mag
            c_err = max(c_err, float(diff.max()))
            c_ratio = max(c_ratio, float((diff / bound).max()))
        return dict(b_ok=b_ok, c_max_abs=c_err, c_max_over_bound=c_ratio)

    @fed.remote
    def async_version(expect):
        _wait_for(lambda: async_rounds.get_session("secure") is not None
                  and async_rounds.get_session("secure").version >= 1,
                  "the secure async version", PRIVACY_TIMEOUT_S / 4)
        agg = async_rounds.get_session("secure")
        cur = agg.current()
        return dict(version=cur["version"],
                    publishes=agg.snapshot_stats()["publishes"],
                    bitwise=_bitwise_equal(cur["params"], expect))

    def report():
        streams = {}
        for (domain, rnd, partner), marks in rec["streams"].items():
            if (domain, rnd) == rec["a_round"]:
                ms = sum(timer.ms(a, b) for a, b, _ in marks)
                words = sum(n for _, _, n in marks)
                streams[partner] = dict(ms=ms, words=words,
                                        gb_s=4 * words / ms / 1e6)
        return dict(
            streams=streams,
            encode_ms=[timer.ms(a, b) for a, b in rec["encode"]],
            sum_ms=[timer.ms(a, b) for a, b in rec["sums"]],
            decode_ms=[timer.ms(a, b) for a, b in rec["decodes"]],
            launches=out["launches"], loss=out["loss"],
            step_peak=out.get("step_peak"),
            round_peak=(torch.cuda.max_memory_allocated() if on_cuda
                        else None))

    remote_report = fed.remote(report)

    def wall(agg, t0):
        return fed.get(stamp.party(root).remote(agg)) - t0

    # Every party has stepped before any round is timed.
    fed.get([stamp.party(p).remote(None) for p in PRIVACY_PARTIES])
    objs = {p: get_tree.party(p).remote("params") for p in PRIVACY_PARTIES}
    t0 = time.perf_counter()
    plain = fed_aggregate(objs, op="mean")
    plain_wall = wall(plain, t0)
    t0 = time.perf_counter()
    sec = fed_aggregate(objs, op="mean", secure=True)
    sec_wall = wall(sec, t0)
    checks = fed.get(check_round.party(root).remote(
        sec, *[objs[p] for p in PRIVACY_PARTIES]))
    del plain, sec

    # The grid round runs the secure fold first, so each order is timed.
    gobjs = {p: get_tree.party(p).remote("grid") for p in PRIVACY_PARTIES}
    t0 = time.perf_counter()
    gsec = fed_aggregate(gobjs, op="mean", secure=True)
    gsec_wall = wall(gsec, t0)
    t0 = time.perf_counter()
    gplain = fed_aggregate(gobjs, op="mean")
    gplain_wall = wall(gplain, t0)
    checks["d_bitwise"] = fed.get(same.party(root).remote(gsec, gplain))
    del gplain

    survivors = PRIVACY_PARTIES[:2]
    envs = [_secagg_mask.party(p).remote(
        gobjs[p], p, PRIVACY_PARTIES, PRIVACY_DROPOUT_DOMAIN, 0, None)
        for p in survivors]
    envs.append(withheld.party("carol").remote(gobjs["carol"]))
    acks = [reoffer.party(p).remote("carol") for p in survivors]
    recovered = _secagg_reduce.party(root).remote(
        "mean", PRIVACY_PARTIES, PRIVACY_DROPOUT_DOMAIN, 0, None,
        *envs, *acks)
    checks["e_bitwise"] = fed.get(same.party(root).remote(
        recovered, fed_aggregate({p: gobjs[p] for p in survivors},
                                 op="mean")))

    h = async_rounds.async_round(gobjs, root=root, round_tag=0,
                                 session="secure", buffer_k=2, secure=True,
                                 fetch_model=False)
    checks["f"] = fed.get(async_version.party(root).remote(gsec))
    checks["f"]["offers"] = fed.get([h.offers[p] for p in PRIVACY_PARTIES])

    # (a): this party's mask words at both ends of the largest leaf, the
    # card's (masked minus encoded) against the CPU's plain path.
    domain, rnd = rec["a_round"]
    idx, n = rec["a_idx"], rec["a_numel"]
    k = min(n_check, n)
    a_ok = True
    for got_enc, got_masked, start in zip(rec["a_enc"], rec["a_masked"],
                                          (0, n - k)):
        card = ((got_masked - got_enc) & 0xFFFFFFFF).cpu()
        cpu = torch.zeros(k, dtype=torch.int64)
        for q in others:
            key = secagg._mask_key(mgr.pair_seed(q), domain, rnd, idx)
            words = threefry.words(key, start, start + k)
            cpu = (cpu + secagg.pair_sign(party, q) * words) & 0xFFFFFFFF
        a_ok = a_ok and torch.equal(card, cpu)
    out.update(a_ok=a_ok, a_leaf=idx, a_numel=n, a_words=k,
               walls=dict(plain=plain_wall, secure=sec_wall,
                          grid_secure=gsec_wall, grid_plain=gplain_wall),
               checks=checks, reports=dict(zip(PRIVACY_PARTIES, fed.get(
                   [remote_report.party(p).remote()
                    for p in PRIVACY_PARTIES]))))
    fed.shutdown()
    # The DP job starts from nothing of this one: the privacy plane's own
    # functions back, this job's trees and captures freed.
    secagg.encode_tree, secagg._accumulate = live["encode"], live["acc"]
    secagg.modular_sum_host, secagg.decode_sum = live["modsum"], live["decode"]
    state.clear()
    rec.clear()
    del params, gsec, recovered, h, objs, gobjs, envs, acks
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    out["dp"] = _dp_job(party, dp_addresses, device, cfg, batch, seq,
                        dp_privacy)
    return out


def _dp_job(party, addresses, device, cfg, batch, seq, dp_privacy):
    """Phase 10's second job, ``DP_JOB``: the privacy config
    ``dp_privacy`` adds the DP layer (``clip_norm``, ``noise_multiplier``,
    ``noise_seed``) and the int8 quantizer, with
    ``payload_wire_dtype="int8"``. Each party takes
    ``DP_STEPS`` bf16 steps, then (1) a secure mean at alice: each party
    clips its tree on the card before masking, alice adds the round's
    noise; (g) each party's clipped tree against the CPU port's clip of
    the same tree; (h) at alice, the noise (the DP mean against the
    un-noised mean of the same envelopes) at both ends of the largest
    leaf against the CPU port's draws, its moments over every entry, a
    second draw, and the ledger; (2) bob pushes his trained f32 tree to
    alice as a plaintext owner push under the int8 tier, (i) checked
    against the CPU port's ``dequantize_tree(quantize_tree(tree))``."""
    import gc
    import math

    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh, tracing
    from rayfed_tpu_torch.data import make_batch_iterator, synthetic_lm_dataset
    from rayfed_tpu_torch.federated import fed_aggregate
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.privacy import dp, quantize, secagg, threefry
    from rayfed_tpu_torch.privacy.manager import get_privacy_manager

    on_cuda = torch.device(device).type == "cuda"
    root, pusher = PRIVACY_PARTIES[0], PRIVACY_PARTIES[1]
    timer = _DeviceTimer(on_cuda)
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp", job_name=DP_JOB,
             config={"cross_silo_comm": dict(FED_COMM,
                                             payload_wire_dtype="int8"),
                     "barrier_on_initializing": True,
                     "privacy": dict(dp_privacy)})
    dev = mesh.get_party_device() if on_cuda else torch.device("cpu")
    mgr = get_privacy_manager()
    out = dict(party=party)

    fa.reset_launch_counts()
    init_fn, step_fn = make_fed_train_step(cfg, dev, lr=1e-3)
    params, opt = init_fn(0)
    seeds = {p: 10 + i for i, p in enumerate(PRIVACY_PARTIES)}
    data = synthetic_lm_dataset(cfg.vocab, DP_STEPS * batch * (seq + 1), seq,
                                seed=seeds[party])
    batches = make_batch_iterator(data, batch, dev)
    losses = []
    for _ in range(DP_STEPS):
        inputs, targets = next(batches)
        params, opt, loss = step_fn(params, opt, inputs, targets)
        losses.append(float(loss))
    out.update(losses=losses, launches=dict(fa.LAUNCHES))
    del opt, inputs, targets, step_fn, batches
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # Captures around the DP layer's own functions: the first clip (its
    # input, output, the input's norm and ms) and the root's noise.
    rec = {}
    live_clip, live_dp = dp.clip_tree, mgr.apply_dp

    def clip_tree(tree, clip_norm):
        norm = dp.tree_l2_norm(tree)
        a = timer.mark()
        clipped = live_clip(tree, clip_norm)
        b = timer.mark()
        rec.setdefault("clip", dict(tree=tree, clipped=clipped, norm=norm,
                                    ms=timer.ms(a, b)))
        return clipped

    def apply_dp(tree, parties, round_index, op="mean"):
        a = timer.mark()
        noisy = live_dp(tree, parties, round_index, op=op)
        b = timer.mark()
        rec["dp"] = dict(clean=tree, noisy=noisy, n=len(parties),
                         round=round_index, ms=timer.ms(a, b))
        return noisy

    dp.clip_tree, mgr.apply_dp = clip_tree, apply_dp
    state = {"params": params}

    @fed.remote
    def get_tree():
        return state["params"]

    @fed.remote
    def stamp(_agg):
        if on_cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    @fed.remote
    def check_noise(sec):
        """(h) at the root."""
        d = rec.pop("dp")
        clean, noisy = d["clean"], d["noisy"]
        # The manager's stddev: z * (clip_norm / n), in that order.
        sigma = dp_privacy["noise_multiplier"] * (
            dp_privacy["clip_norm"] / d["n"])
        cl, nl = secagg._leaves(clean)[0], secagg._leaves(noisy)[0]
        idx = max(range(len(cl)), key=lambda i: (cl[i].numel(), -i))
        n = cl[idx].numel()
        k = min(PRIVACY_CHECK_WORDS, n)
        key = threefry.fold_in(threefry.prng_key(
            dp_privacy["noise_seed"] % (1 << 63)), d["round"] & 0x7FFFFFFF)
        key = threefry.fold_in(key, idx)
        ends_ok = True
        for start in (0, n - k):
            x = cl[idx].reshape(-1)[start:start + k].cpu()
            draws = threefry.normal_range(key, start, start + k).double()
            want = dp._cast_back(x.double() + draws * sigma, x)
            got = nl[idx].reshape(-1)[start:start + k].cpu()
            ends_ok = ends_ok and torch.equal(got.view(torch.int32),
                                              want.view(torch.int32))
        total = s1 = s2 = 0.0
        for c, z in zip(cl, nl):
            e = (z.double() - c.double()) / sigma
            total += e.numel()
            s1 += float(e.sum())
            s2 += float((e * e).sum())
            del e
        mean = s1 / total
        std = math.sqrt(max(0.0, s2 / total - mean * mean))
        a = timer.mark()
        again = dp.gaussian_noise_tree(
            clean, sigma, dp_privacy["noise_seed"], d["round"])
        again_ms = timer.ms(a, timer.mark())
        redraw = _bitwise_equal(again, noisy)
        del again
        eps = math.sqrt(2 * math.log(1.25 / DP_DELTA)) \
            / dp_privacy["noise_multiplier"]
        ledger = fed.privacy_ledger()
        return dict(
            leaf=idx, numel=n, words=k, ends_ok=ends_ok, entries=total,
            mean=mean, std=std, se_mean=1 / math.sqrt(total),
            se_std=1 / math.sqrt(2 * total), sigma=sigma,
            redraw_bitwise=redraw, noise_ms=d["ms"], again_ms=again_ms,
            returned_is_noisy=_bitwise_equal(sec, noisy), ledger=ledger,
            ledger_ok=(set(ledger) == set(PRIVACY_PARTIES) and all(
                r["rounds"] == 1 and r["epsilon"] == eps
                and r["delta"] == DP_DELTA for r in ledger.values())),
            epsilon=eps)

    @fed.remote
    def check_clip():
        """(g) in each party: the card's clip of its tree against the CPU
        port's clip of the same tree, leaf for leaf."""
        c = rec.pop("clip")
        cpu_in = _host_tree(c["tree"])
        t = time.perf_counter()
        want = dp.clip_tree(cpu_in, dp_privacy["clip_norm"])
        cpu_ms = 1e3 * (time.perf_counter() - t)
        ok = all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                 for a, b in zip(secagg._leaves(c["clipped"])[0],
                                 secagg._leaves(want)[0]))
        return dict(ok=ok, norm=c["norm"], ms=c["ms"], cpu_ms=cpu_ms,
                    cpu_norm=dp.tree_l2_norm(cpu_in))

    @fed.remote
    def push_tree():
        tree = state["params"]
        if on_cuda:
            torch.cuda.synchronize()
        return dict(tree=tree, t_sent=time.time())

    @fed.remote
    def expected_digest():
        """What the int8 tier must deliver: the CPU port's
        ``dequantize_tree(quantize_tree(tree))`` (JAX leaf order); and
        the tier's sender work timed apart: each leaf quantized on the
        card and its int8 words copied to host."""
        a = timer.mark()
        for leaf in secagg._leaves(state["params"])[0]:
            q, _ = quantize.quantize_leaf(leaf)
            q.cpu()
            del q
        card_ms = timer.ms(a, timer.mark())
        cpu = _host_tree(state["params"])
        t = time.perf_counter()
        back = quantize.dequantize_tree(quantize.quantize_tree(cpu))
        return dict(digest=_tree_digest(back),
                    f32_bytes=_tree_nbytes(cpu), card_ms=card_ms,
                    cpu_ms=1e3 * (time.perf_counter() - t))

    @fed.remote
    def arrived(msg):
        if on_cuda:
            torch.cuda.synchronize()
        t = time.time()
        tree = msg["tree"]
        leaves = secagg._leaves(tree)[0]
        return dict(ms=1e3 * (t - msg["t_sent"]),
                    decode_ms=_span_ms(_last_span("decode", 1)),
                    place_ms=_span_ms(_last_span("place", 1)),
                    digest=_tree_digest(secagg.jax_order(tree)),
                    on_device=all(x.device == dev for x in leaves),
                    dtypes=sorted({str(x.dtype) for x in leaves}))

    def wall(agg, t0):
        return fed.get(stamp.party(root).remote(agg)) - t0

    fed.get([stamp.party(p).remote(None) for p in PRIVACY_PARTIES])
    objs = {p: get_tree.party(p).remote() for p in PRIVACY_PARTIES}
    t0 = time.perf_counter()
    sec = fed_aggregate(objs, op="mean", secure=True)
    out["secure_wall"] = wall(sec, t0)
    noise = fed.get(check_noise.party(root).remote(sec))
    del sec
    clips = fed.get([check_clip.party(p).remote() for p in PRIVACY_PARTIES])
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # (i): bob's plaintext owner push under the int8 tier.
    if party in (root, pusher):
        tracing.enable()
    if party == pusher:
        saved0 = mgr.stats["quantized_bytes_saved"]
    want = fed.get(expected_digest.party(pusher).remote())
    got = fed.get(arrived.party(root).remote(push_tree.party(pusher).remote()))
    if party == pusher:
        sends = [sp for sp in tracing.get_spans("send")]
        big = max(sends, key=lambda sp: sp.nbytes)
        out["push"] = dict(saved=mgr.stats["quantized_bytes_saved"] - saved0,
                           wire_bytes=big.nbytes, send_ms=_span_ms(big),
                           stage_ms=_span_ms(_last_span("stage", 1)))
    if party in (root, pusher):
        tracing.disable()
    out.update(noise=noise, clips=dict(zip(PRIVACY_PARTIES, clips)),
               int8=dict(want=want, got=got),
               peak=(torch.cuda.max_memory_allocated() if on_cuda else None))
    dp.clip_tree = live_clip
    fed.shutdown()
    return out


def mask_stream_alone(device, cfg, reps=3):
    """One partner's mask stream added to a leaf of the model's largest
    shape (the embedding), alone in this process: ms (CUDA events, the
    mean of ``reps`` after a warm-up on a card; the host clock on the
    CPU), GB/s of words, and the bytes bound of one fused pass (read the
    encoded word, write the masked one: 8 B a word at 3.35 TB/s)."""
    import torch

    from rayfed_tpu_torch.privacy import secagg

    words = torch.zeros(cfg.vocab * cfg.d_model, dtype=torch.int64,
                        device=device)
    timer = _DeviceTimer(torch.device(device).type == "cuda")

    def once():
        secagg.mask_leaf(words, 0, "alice", ("alice", "bob"),
                         {"bob": PRIVACY_MASK_SEED}, "smoke-alone", 0,
                         inplace=True)

    once()
    a = timer.mark()
    for _ in range(reps):
        once()
    ms = timer.ms(a, timer.mark()) / reps
    n = words.numel()
    return dict(words=n, ms=ms, gb_s=4 * n / ms / 1e6,
                fused_bound_ms=1e3 * 8 * n / PEAK_BYTES_PER_S)


def phase_privacy(device, cfg, *, batch, seq, label="",
                  timeout_s=PRIVACY_TIMEOUT_S, f32_push=None):
    """Phase 10: :func:`_privacy_program` in three spawned party
    processes on one card, checked: (a) each party's mask words at the
    first and last 2**20 flat indices of the largest leaf equal the CPU
    plain path's bitwise, (b) the ring sum of the three masked envelopes
    equals the ring sum of the three plain encodings bitwise, (c) the
    secure mean is within 2**-(f+1) plus eight f32 epsilons of the
    entries' mean magnitude of the plaintext ``tree_mean``, (d) over
    grid-valued trees the secure mean is bitwise the plaintext fold,
    (e) carol's envelope withheld, alice's and bob's re-offered seeds
    recover the survivors' plaintext mean bitwise, (f) one secure async
    version (``buffer_k`` 2) folds the three offers and publishes (d)'s
    mean bitwise; each party's steps launched every bf16 kernel on a
    card. Then the DP job's (g)-(i) (:func:`check_dp`). Returns the
    parties' results."""
    import dataclasses

    import torch

    t10 = time.perf_counter()
    alone = mask_stream_alone(device, cfg)
    dp_addresses = {n: f"127.0.0.1:{_free_port()}" for n in PRIVACY_PARTIES}
    dp_privacy = dict(DP_PRIVACY, clip_norm=dp_clip_norm(cfg, device))
    results, wall = spawn_parties(
        _privacy_program,
        (device, dataclasses.asdict(cfg), batch, seq, dp_addresses,
         dp_privacy), timeout_s, names=PRIVACY_PARTIES)
    res = results["alice"]
    checks, reports = res["checks"], res["reports"]
    for p, r in results.items():
        require(r["a_ok"], f"(a) {p}'s mask words on the card differ from "
                           f"the CPU's at the ends of leaf {r['a_leaf']}")
    require(checks["b_ok"], "(b) the masked envelopes' ring sum is not the "
                            "plain encodings' ring sum")
    require(checks["c_max_over_bound"] <= 1.0,
            f"(c) the secure mean is {checks['c_max_over_bound']:.3f} times "
            f"the bound from the plaintext tree_mean")
    require(checks["d_bitwise"], "(d) the secure mean of grid-valued trees "
                                 "is not the plaintext fold's bits")
    require(checks["e_bitwise"], "(e) the round with carol's envelope "
                                 "withheld did not recover the survivors' "
                                 "mean bitwise")
    f = checks["f"]
    require(f["version"] == 1 and f["publishes"] == 1 and f["bitwise"]
            and all(o["accepted"] for o in f["offers"]),
            f"(f) the secure async version: {f}")
    if torch.device(device).type == "cuda":
        for p, rep in reports.items():
            for k in BF16_KERNELS:
                require(rep["launches"][k] > 0,
                        f"{p} did not launch {k}: {rep['launches']}")
    for p, rep in reports.items():
        print(f"[privacy] {label} {p}: " + ", ".join(
            f"mask stream with {q} {s['ms']:.1f} ms ({s['words']} words, "
            f"{s['gb_s']:.1f} GB/s of words)"
            for q, s in sorted(rep["streams"].items()))
            + f"; encode {', '.join(f'{m:.1f}' for m in rep['encode_ms'])}"
            f" ms; peak {rep['step_peak']} B in the step, "
            f"{rep['round_peak']} B in the rounds")
    print(f"[privacy] {label} one partner stream alone over {alone['words']}"
          f" words: {alone['ms']:.2f} ms ({alone['gb_s']:.1f} GB/s of words;"
          f" a fused pass's bytes bound {alone['fused_bound_ms']:.3f} ms)")
    root = reports["alice"]
    print(f"[privacy] {label} alice: ring sum "
          f"{', '.join(f'{m:.1f}' for m in root['sum_ms'])} ms, decode "
          f"{', '.join(f'{m:.1f}' for m in root['decode_ms'])} ms")
    w = res["walls"]
    print(f"[privacy] {label} round wall at alice, trained trees: plaintext "
          f"{w['plain']:.3f} s, then secure {w['secure']:.3f} s (first secure"
          f" round, seed exchange included; {w['secure'] / w['plain']:.2f}x);"
          f" grid trees: secure {w['grid_secure']:.3f} s, then plaintext "
          f"{w['grid_plain']:.3f} s "
          f"({w['grid_secure'] / w['grid_plain']:.2f}x)")
    print(f"[privacy] {label} checks: (a) leaf {res['a_leaf']} "
          f"({res['a_numel']} words), {res['a_words']} words at each end in "
          f"all three parties; (b) {checks['b_ok']}; (c) max |secure - "
          f"plain| {checks['c_max_abs']:.6e}, {checks['c_max_over_bound']:.6f}"
          f" of the bound; (d) {checks['d_bitwise']}; (e) "
          f"{checks['e_bitwise']}; (f) version {f['version']}; losses "
          + ", ".join(f"{p} {r['loss']:.4f}" for p, r in reports.items())
          + f"; the secure job's part of the phase "
          f"{time.perf_counter() - t10:.1f} s")
    check_dp(results, device, label, dp_privacy, f32_push)
    print(f"[privacy] {label} phase 10 {time.perf_counter() - t10:.1f} s "
          f"({wall:.1f} s from spawn to exit)")
    return results


def dp_clip_norm(cfg, device):
    """``DP_CLIP_FRACTION`` of the L2 norm of ``cfg``'s initial params
    (the parties' trees start from them), to two significant digits."""
    import gc

    import torch

    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.privacy import dp

    params = tfm.init_params(0, cfg, device)
    norm = dp.tree_l2_norm(params)
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return float(f"{DP_CLIP_FRACTION * norm:.2g}")


def check_dp(results, device, label, dp_privacy, f32_push=None):
    """Phase 10's checks (g)-(i) over the DP job's results, and its
    report: each party's clip, alice's noise and ledger, bob's int8
    push beside phase 5's f32 push (``f32_push``: its bytes and ms)."""
    import torch

    dps = {p: r["dp"] for p, r in results.items()}
    root = dps["alice"]
    for p, c in root["clips"].items():
        require(c["ok"], f"(g) {p}'s clipped tree on the card differs from "
                         f"the CPU port's clip")
        require(c["norm"] > dp_privacy["clip_norm"] and
                c["norm"] == c["cpu_norm"],
                f"(g) {p}'s norm {c['norm']} (CPU {c['cpu_norm']}): the clip "
                f"must act and the norms agree")
    n = root["noise"]
    require(n["ends_ok"], f"(h) the noise at the ends of leaf {n['leaf']} "
                          f"differs from the CPU port's draws")
    require(abs(n["mean"]) <= DP_MOMENT_SE * n["se_mean"]
            and abs(n["std"] - 1.0) <= DP_MOMENT_SE * n["se_std"],
            f"(h) noise / stddev over {n['entries']} entries: mean "
            f"{n['mean']:.3e}, std {n['std']:.6f}")
    require(n["redraw_bitwise"] and n["returned_is_noisy"],
            f"(h) a second draw of the same (seed, round): {n}")
    require(n["ledger_ok"], f"(h) the ledger at alice: {n['ledger']}, one "
                            f"round of {n['epsilon']} each expected")
    i8 = root["int8"]
    push = dps["bob"]["push"]
    f32 = i8["want"]["f32_bytes"]
    require(i8["got"]["digest"] == i8["want"]["digest"],
            "(i) alice's tree from bob's int8 push is not the CPU port's "
            "dequantize_tree(quantize_tree(tree))")
    require(i8["got"]["on_device"]
            and i8["got"]["dtypes"] == ["torch.float32"],
            f"(i) the pushed tree arrived as {i8['got']}")
    require(4 * push["wire_bytes"] == f32,
            f"(i) {push['wire_bytes']} bulk bytes on the wire for {f32} f32 "
            f"bytes: not a quarter")
    require(4 * push["saved"] == 3 * f32,
            f"(i) quantized_bytes_saved grew by {push['saved']}, not three "
            f"quarters of {f32}")
    if torch.device(device).type == "cuda":
        for p, d in dps.items():
            for k in BF16_KERNELS:
                require(d["launches"][k] > 0,
                        f"{p}'s DP-job steps did not launch {k}: "
                        f"{d['launches']}")
    for p, c in root["clips"].items():
        print(f"[privacy] {label} DP {p}: norm {c['norm']:.6f} clipped to "
              f"{dp_privacy['clip_norm']} on the party's device in "
              f"{c['ms']:.1f} ms "
              f"(the CPU port's clip {c['cpu_ms']:.1f} ms): (g) bitwise; "
              f"losses {[round(x, 4) for x in dps[p]['losses']]}, launches "
              f"{dps[p]['launches']}, peak {dps[p]['peak']} B")
    print(f"[privacy] {label} DP alice: secure DP round wall "
          f"{root['secure_wall']:.3f} s; noise over {n['entries']:.0f} "
          f"entries (stddev {n['sigma']:.6f}) {n['noise_ms']:.1f} ms, a "
          f"second draw {n['again_ms']:.1f} ms, bitwise the first; (h) the "
          f"ends of leaf {n['leaf']} ({n['numel']} entries, {n['words']} "
          f"each) equal the CPU port's draws; noise / stddev mean "
          f"{n['mean']:.3e} ({n['mean'] / n['se_mean']:.2f} standard "
          f"errors), std {n['std']:.6f} "
          f"({(n['std'] - 1) / n['se_std']:.2f} standard errors); ledger "
          f"{n['ledger']}")
    rate = f32 / i8["got"]["ms"] / 1e6
    wire = push["wire_bytes"] / i8["got"]["ms"] / 1e6
    base = ("phase 5 not run" if not f32_push else
            f"phase 5's f32 push of {f32_push['nbytes']} B: "
            f"{f32_push['push_ms']:.1f} ms, "
            f"{f32_push['nbytes'] / f32_push['push_ms'] / 1e6:.3f} GB/s")
    print(f"[privacy] {label} int8 push bob -> alice: {f32} f32 bytes as "
          f"{push['wire_bytes']} bulk bytes ({push['saved']} saved): "
          f"{i8['got']['ms']:.1f} ms, {rate:.3f} GB/s of f32 "
          f"({wire:.3f} GB/s on the wire); capture "
          f"{push['stage_ms']:.1f} ms, socket send {push['send_ms']:.1f} ms, "
          f"alice's decode (dequantize on the host included) "
          f"{_fmt_ms(i8['got']['decode_ms'])}, "
          f"placement on the card {_fmt_ms(i8['got']['place_ms'])}; timed "
          f"apart at bob, quantize on the card and copy to host "
          f"{i8['want']['card_ms']:.1f} ms, the CPU port's quantize + "
          f"dequantize {i8['want']['cpu_ms']:.1f} ms; "
          f"{base}")


def _fmt_ms(v):
    return "not measured" if v is None else f"{v:.1f} ms"


def run_privacy(smi, f32_push=None):
    """Phase 10 at the flagship width, depth cut as phase 4's, batch cut
    to PRIVACY_BATCH."""
    print("[privacy] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS],
         "batch": [FLAGSHIP["batch"], PRIVACY_BATCH]}))
    t = _phase_begin(10)
    out = phase_privacy("cuda", _flagship_cfg(PARTY_LAYERS),
                        batch=PRIVACY_BATCH, seq=FLAGSHIP["seq"],
                        label=f"on {smi}:", f32_push=f32_push)
    _phase_wall(10, t, smi)
    return out

# ---------------------------------------------------------------------------
# Phase 11: the device-DMA push lane
# ---------------------------------------------------------------------------

# Each of phase 11's jobs' join deadline (phase 11: 38.8 s).
DMA_TIMEOUT_S = 110
# Phase 11 (a)'s rounds of phase 5's program on the DMA lane: one. A
# second repeats the first's checks on the lane; what it adds, a round
# starting from the loaded aggregate, phase 5's native run checks.
DMA_ROUNDS = 1


def _fmt_parts(parts):
    if not parts:
        return "not split"
    return ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + " ms"


def dma_bound_ms(nbytes):
    """The least time a push of ``nbytes`` between two processes on one
    card could take: two device copies (the sender's snapshot and the
    receiver's pull), each reading and writing every byte once."""
    return 1e3 * 2 * (2 * nbytes) / PEAK_BYTES_PER_S


def _card_memory(dev):
    """The card's free bytes (all processes) and this process's bytes in
    PyTorch's allocator."""
    import torch

    return dict(free=torch.cuda.mem_get_info(dev)[0],
                reserved=torch.cuda.memory_reserved(dev))


def _dma_push_program(party, addresses, device, cfg_kw):
    """Phase 11 (b) and (d): alice pushes a 4 MiB tree to bob over the
    device-DMA lane (bob's first pull: his CUDA context and the lane's
    library come up in it), then the flagship f32 tree at its
    initialization, then a tree with a string leaf. The owner reads the
    card's free memory before the warm-up push, before the big push and
    after its pull; bob reports what his allocator holds after each
    pull."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh, tracing, tree_util
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.proxy.cuda import dma

    cfg = tfm.TransformerConfig(**cfg_kw)
    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda",
             config={"cross_silo_comm": dict(FED_COMM, device_dma=True)})
    dev = mesh.get_party_device()

    @fed.remote
    class Owner:
        def __init__(self):
            self.params = tfm.init_params(0, cfg, dev)
            self.digest = _tree_digest(self.params)
            self.memory = []

        def warm(self):
            self.memory.append(_card_memory(dev))
            return {"w": torch.ones(1 << 20, device=dev)}

        def push(self):
            self.memory.append(_card_memory(dev))
            return self.params

        def after(self):
            # Read once the lane freed the snapshot (the server frees it
            # when bob says "done", before bob's receive ends).
            lane = _idle_lane_stats()
            return dict(digest=self.digest, lane=lane,
                        memory=self.memory + [_card_memory(dev)])

    @fed.remote
    def receive(tree):
        _, info = _arrive(tree, dev, kind="pull")
        info["devices"] = sorted({str(x.device)
                                  for x in tree_util.tree_flatten(tree)[0]})
        del tree, _
        # What bob holds on the card when the owner next reads its free
        # memory: the pulled buffer (the runtime may still hold the tree).
        torch.cuda.empty_cache()
        info["reserved"] = torch.cuda.memory_reserved(dev)
        return info

    @fed.remote
    def sender_spans(nbytes):
        return _sender_spans(nbytes)

    @fed.remote
    def mixed():
        return {"tag": "socket lane",
                "w": torch.arange(1024, dtype=torch.float32, device=dev)}

    @fed.remote
    def receive_mixed(tree):
        return dict(tag=tree["tag"], device=str(tree["w"].device),
                    bitwise=bool(torch.equal(tree["w"].cpu(),
                                             torch.arange(1024.0))),
                    pulls=dma.stats()["pulls"])

    owner = Owner.party("alice").remote()
    first = fed.get(receive.party("bob").remote(owner.warm.remote()))
    info = fed.get(receive.party("bob").remote(owner.push.remote()))
    after = fed.get(owner.after.remote())
    info.update(fed.get(sender_spans.party("alice").remote(info["nbytes"])))
    info["push_ms"] = 1e3 * (info["arrived_at"] - info["stage_start"])
    got_mixed = fed.get(receive_mixed.party("bob").remote(
        mixed.party("alice").remote()))
    fed.shutdown()
    return dict(push=info, first=first, owner=after, mixed=got_mixed,
                device=str(dev))


def _split_program(party, addresses):
    """Phase 11 (c): ``rayfed_tpu_torch/examples/split_learning.py`` as
    its ``main`` runs it on the card (``transport="cuda"``,
    ``device_dma``)."""
    from rayfed_tpu_torch.examples import split_learning

    step_ms = []
    losses = split_learning.run(party, addresses, step_ms=step_ms)
    return dict(losses=losses, step_ms=step_ms, lane=_idle_lane_stats(),
                steps=split_learning.STEPS)


def _require_ipc_only(lane, party, n, what):
    require(lane["pulls"] == {"ipc": n, "local": 0, "socket": 0},
            f"{what}: {party}'s pulls by engine {lane['pulls']}, not "
            f"{n} by ipc and none by another engine")
    require(lane["device_snapshots"] == 0 and lane["device_bytes"] == 0
            and lane["parked"] == 0,
            f"{what}: {party}'s lane still holds snapshots after the "
            f"pulls: {lane}")


def phase_dma(device, cfg, *, batch, seq, label="", fed_push=None,
              timeout_s=DMA_TIMEOUT_S):
    """Phase 11: the device-DMA lane between two party processes on the
    card (``transport="cuda"``, ``device_dma``). (a) Phase 5's round
    program at ``cfg``: its checks (a)-(g), and every params, aggregate
    and bf16 push served by ``ipc``, none by another engine; the root's
    aggregate on the card is bitwise the CPU fold of the two trees; each
    sender's lane holds no snapshot after the pulls. (b) A 4 MiB tree
    (the receiver's first pull), then one push of the flagship f32 tree at
    full depth, at its initialization: bitwise, by ``ipc``; the card's free
    memory after the pull, less what bob's allocator took in it, within
    64 MiB of the free memory before the push (a snapshot that was not freed
    would take its 3 GB), and the owner's lane empty. (c) The split-learning example, 10
    steps: the loss falls, every activation and gradient push by ``ipc``.
    (d) A tree with a string leaf rides the socket lane. Returns (a)'s
    party results (their launches count in the kernel line)."""
    import dataclasses

    root, other = (n for n, _ in PARTIES)
    results, wall = spawn_parties(
        _fed_program, (device, dataclasses.asdict(cfg), batch, seq,
                       DMA_ROUNDS, 2, 1e-3, True), timeout_s)
    check_fed(results, device, wall, f"{label} (a)", dma=True)
    res = results[root]
    lanes = res["lanes"]
    for r, rnd in enumerate(res["rounds"]):
        for push in ("params_push", "aggregate_push"):
            require(rnd[push]["engine"] == "ipc",
                    f"(a) round {r}: the {push} was pulled by "
                    f"{rnd[push]['engine']}, not ipc")
        require(rnd["params_push"]["fold_mismatched"] == 0,
                f"(a) round {r}: the aggregate on the card differs from the "
                f"CPU fold in {rnd['params_push']['fold_mismatched']} "
                f"elements")
    # The root pulls each round's params and the bf16 tree; the other
    # party each round's aggregate.
    _require_ipc_only(lanes[root], root, DMA_ROUNDS + 1, "(a)")
    _require_ipc_only(lanes[other], other, DMA_ROUNDS, "(a)")

    full = dataclasses.replace(cfg, n_layers=FLAGSHIP["n_layers"])
    pushed, push_wall = spawn_parties(
        _dma_push_program, (device, dataclasses.asdict(full)), timeout_s)
    big, first, owner, mixed = (pushed[root][k]
                                for k in ("push", "first", "owner", "mixed"))
    require(all(pushed[other][k] == pushed[root][k]
                for k in ("push", "first", "mixed")),
            "(b) the parties disagree on values both fetched")
    require(big["digest"] == owner["digest"],
            "(b) the full-depth tree arrived with other bytes than its "
            "owner's")
    party_dev = pushed[other]["device"]
    require(first["engine"] == "ipc" and first["devices"] == [party_dev],
            f"(b) the first tree was pulled by {first['engine']} onto "
            f"{first['devices']}")
    require(big["engine"] == "ipc" and big["devices"] == [party_dev],
            f"(b) the full-depth tree was pulled by {big['engine']} onto "
            f"{big['devices']}")
    _require_ipc_only(owner["lane"], root, 0, "(b)")
    cold, before, after = owner["memory"]
    drop = before["free"] - after["free"]
    bobs = big["reserved"] - first["reserved"]
    alices = after["reserved"] - before["reserved"]
    require(drop - bobs - alices <= 64 << 20,
            f"(b) the card's free memory fell by {drop} B over the push, of "
            f"which bob's allocator took {bobs} B and alice's {alices} B: "
            f"the snapshot was not freed")
    require(mixed["tag"] == "socket lane" and mixed["bitwise"]
            and mixed["device"] == party_dev
            and mixed["pulls"] == {"ipc": 2, "local": 0, "socket": 0},
            f"(d) the tree with a string leaf: {mixed}")

    split, split_wall = spawn_parties(_split_program, (), timeout_s)
    losses = split[root]["losses"]
    require(split[other]["losses"] == losses,
            "(c) the parties fetched different losses")
    require(losses[-1] < losses[0], f"(c) the loss did not fall: {losses}")
    for n, got in split.items():
        # Alice pulls each step's gradient, bob its activation.
        _require_ipc_only(got["lane"], n, got["steps"], "(c)")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    rate = big["nbytes"] / big["push_ms"] / 1e6
    print(f"[dma] {label} (b) bob's first pull, {first['nbytes']} B by "
          f"{first['engine']}: {ms(first['pull_ms'])} "
          f"({_fmt_parts(first['pull_parts'])})")
    print(f"[dma] {label} (b) full-depth f32 tree {big['nbytes']} B alice -> "
          f"bob by {big['engine']}: {big['push_ms']:.1f} ms, {rate:.3f} GB/s; "
          f"snapshot on the card {ms(big['stage_ms'])}, descriptor send "
          f"{ms(big['send_ms'])}, pull {ms(big['pull_ms'])} "
          f"({_fmt_parts(big['pull_parts'])}); bound "
          f"{dma_bound_ms(big['nbytes']):.2f} ms; two processes in "
          f"{push_wall:.1f} s from spawn to exit")
    print(f"[dma] {label} (b) the card's free memory {cold['free']} B before "
          f"the 4 MiB push, {before['free']} B before the big push, "
          f"{after['free']} B after its pull; bob's allocator "
          f"{first['reserved']} -> {big['reserved']} B, alice's "
          f"{before['reserved']} -> {after['reserved']} B; unexplained "
          f"{drop - bobs - alices} B")
    print(f"[dma] {label} (d) a tree with a string leaf rode the socket lane "
          f"(bob's pulls {mixed['pulls']})")
    step_ms = split[root]["step_ms"]
    print(f"[dma] {label} (c) split learning, {len(losses)} steps over ipc: "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; ms a step median "
          f"{statistics.median(step_ms):.2f} (first {step_ms[0]:.2f}, "
          f"range {min(step_ms):.2f}-{max(step_ms):.2f}); two processes in "
          f"{split_wall:.1f} s from spawn to exit")
    if fed_push:
        print(f"[dma] {label} phase 5's native push of this run: "
              f"{fed_push['nbytes']} B in {fed_push['push_ms']:.1f} ms, "
              f"{fed_push['nbytes'] / fed_push['push_ms'] / 1e6:.3f} GB/s")
    return results


def run_dma(smi, fed_push=None):
    """Phase 11 at the flagship width, depth cut as phase 4's for (a)."""
    print("[dma] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}))
    t = _phase_begin(11)
    out = phase_dma("cuda", _flagship_cfg(PARTY_LAYERS),
                    batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                    label=f"on {smi}:", fed_push=fed_push)
    _phase_wall(11, t, smi)
    return out


# ---------------------------------------------------------------------------
# Phase 12: wide heads (the D = 256 tile plans)
# ---------------------------------------------------------------------------

# Phase 12 (b): the D = 256 kernels of both dtypes against their plain
# versions. D = 136, 160 and 192 run zero-padded to 256; bf16 K1 (warp-
# specialised: a TMA producer, two consumer warpgroups of 64 queries)
# tiles 128 queries x 80 keys, K2 128 queries x 32 keys, K3 (warp-
# specialised: dV and dK in the two consumers) 64 keys x 64 queries; f32
# K1 128 queries x 16 keys, K2 64 queries x 16 keys, K3 64 keys x 16
# queries.
WIDE_SHAPES = [
    (1, 256, 256, 2, 256, 0),
    (2, 96, 160, 3, 136, 64),     # ragged tiles, Sq < Sk, q_offset
    (1, 200, 200, 2, 160, 0),     # S not a multiple of 128, 64, 32 or 16
    (1, 136, 328, 3, 192, 150),   # Sq < Sk, q_offset off a tile boundary
    (1, 136, 328, 3, 256, 192),   # q_offset on a tile boundary
    (2, 64, 64, 2, 256, 0),       # a block's second half has no row
                                  # (bf16 warpgroup, f32 K1 warps 4-7)
    (1, 100, 90, 2, 256, 20),     # queries past the last key; f32 K2:
                                  # the block's last row group has no row
    (4096, 32, 32, 16, 256, 0),   # B*H = 65536 on the grid's x dimension
]


def phase_wide_f32(device, cfg, *, batch, seq, label=""):
    """Phase 12 (e): phase 4b at ``cfg`` (its f32 steps at ``batch``, then
    the batch-1 loss and gradients, flash against dense), then one round
    of phase 4's loop with ``cfg`` in f32. Returns {kernel: launches of
    the f32 steps and of the round's train steps}."""
    import dataclasses
    import gc

    import torch

    from rayfed_tpu_torch.ops import flash_attention as fa

    f32 = phase_f32(device, cfg, batch=batch, seq=seq, label=label)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rnd = phase_slice(device, dataclasses.replace(
        cfg, compute_dtype=torch.float32), batch=batch, seq=seq, rounds=1,
        label=label + " f32")
    return {k: f32["launches"][k] + rnd["launches"][k] for k in fa.LAUNCHES}


def phase_wide(smi):
    """Phase 12: the flagship width in 8 heads of 256 (``WIDE``), depth cut
    as phase 4's. (b) the D = 256 kernels of both dtypes against their
    plain versions at ``WIDE_SHAPES`` and timed at the main path's shape
    beside SDPA (f32 with the exact-f32 reading); (c) phase 4's round loop
    at ``WIDE``, whose train steps must launch every bf16 D = 256 kernel
    and no D <= 128 one; (d) phase 6's transformer program at ``WIDE`` in
    two party processes (its checks (a)-(f), the D = 256 kernels in (e));
    (e) the same in f32: :func:`phase_wide_f32`, whose steps must launch
    every f32 D = 256 kernel and no f32 D <= 128 one. Returns ({kernel:
    results}, {kernel: launches of (c)'s, (d)'s and (e)'s train steps})."""
    import dataclasses
    import gc

    import torch

    t = time.perf_counter()
    kern = {}
    for dtype in ("bfloat16", "float32"):
        for shape in WIDE_SHAPES:
            check_kernels("cuda", *shape, seed=1, dtype=dtype)
        kern.update(time_kernels("cuda", WIDE["batch"], WIDE["seq"],
                                 WIDE["n_heads"], WIDE_HEAD_DIM, dtype, smi))
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[wide] (b) kernels in {time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    cfg = _flagship_cfg(SMOKE_LAYERS, WIDE)
    print("[wide] reduced " + json.dumps(
        {"n_layers": [WIDE["n_layers"], SMOKE_LAYERS]}))
    t = time.perf_counter()
    summary = phase_slice("cuda", cfg, batch=WIDE["batch"], seq=WIDE["seq"],
                          label=f"8 heads of 256 on {smi}:")
    require(all(summary["launches"][k] > 0 for k in WIDE_KERNELS)
            and not any(summary["launches"][k] for k in BF16_KERNELS),
            f"(c) the train steps at D = {WIDE_HEAD_DIM} did not launch every "
            f"D = 256 kernel and none of the D <= 128 ones: "
            f"{summary['launches']}")
    print(f"[wide] (c) round loop in {time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    print("[wide] (d) reduced " + json.dumps(
        {"n_layers": [WIDE["n_layers"], PARTY_LAYERS]}))
    t = time.perf_counter()
    prog = phase_programs("cuda", dataclasses.replace(cfg,
                                                      n_layers=PARTY_LAYERS),
                          batch=WIDE["batch"], seq=WIDE["seq"],
                          label=f"8 heads of 256 on {smi}:",
                          kernels=WIDE_KERNELS, cnn=False)
    print(f"[wide] (d) engine round in {time.perf_counter() - t:.1f} s")
    root = PARTIES[0][0]
    launches = {k: summary["launches"][k] + sum(
        rep["launches"][k]
        for rep in prog["results"][root]["reports"].values())
        for k in WIDE_KERNELS}
    gc.collect()
    torch.cuda.empty_cache()

    print("[wide] f32 reduced " + json.dumps(
        {"n_layers": [WIDE["n_layers"], SMOKE_LAYERS]}))
    t = time.perf_counter()
    f32 = phase_wide_f32("cuda", cfg, batch=WIDE["batch"], seq=WIDE["seq"],
                         label=f"8 heads of 256 on {smi}:")
    require(all(f32[k] > 0 for k in F32_WIDE_KERNELS)
            and not any(f32[k] for k in F32_KERNELS),
            f"(e) the f32 steps at D = {WIDE_HEAD_DIM} did not launch every "
            f"f32 D = 256 kernel and none of the f32 D <= 128 ones: {f32}")
    print(f"[wide] (e) f32 steps and round in {time.perf_counter() - t:.1f} s")
    launches.update({k: f32[k] for k in F32_WIDE_KERNELS})
    return kern, launches


def run_wide(smi):
    """Phase 12 with its wall."""
    t = _phase_begin(12)
    out = phase_wide(smi)
    _phase_wall(12, t, smi)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the operational planes (resilience, TLS, telemetry) around the
# flagship round
# ---------------------------------------------------------------------------

# The chaos schedule of tests/test_resilience.py (its partition, delay and
# drop rules, in its order), cut to OPS_ROUNDS rounds, with two corrupt
# rules added: alice's push of round OPS_CORRUPT_FRAME gets one bit of
# each leaf flipped (frame crc off on her link), bob's push of round
# OPS_CRC_FRAME is tainted on the wire (frame crc on on his), so alice's
# check NACKs it and bob's lane sends it again. Windows count data
# frames: one push a round each way, and the error envelope the engine
# sends in place of a failed push (same seq ids, so the same draws). The
# seed is the first from the reference's that, with this program's seq
# ids, delays alice's first push and drops her third, whose envelope is
# the first frame the cut takes.
OPS_ROUNDS = 3
OPS_SEED = 20260810
OPS_PARTITION_AFTER = 3
OPS_CORRUPT_FRAME = 1
OPS_CRC_FRAME = 2
OPS_WEIGHTS = {"alice": 1.0, "bob": 3.0}
# How long a party's fed.get waits for a push that may never come (bob,
# for alice's dropped push); alice, whose pushes from bob always come,
# waits OPS_ROOT_WAIT times as long, and so does everyone in round 0,
# which builds the trainers. A TLS push of the flagship tree takes 7-30 s
# on the card's host (PERF.md), so a round's parties drift that far.
OPS_GET_TIMEOUT_S = 30.0
OPS_ROOT_WAIT = 3
OPS_DEAD_WAIT_S = 30.0
OPS_LIVENESS = {"interval_ms": 250, "suspect_after": 2, "dead_after": 4,
                # A ping queues behind a 1.36 GB push on the half-duplex
                # TLS lane: only a partition may make it miss.
                "timeout_ms": 120000}
OPS_TELEMETRY = {"collector": "alice", "push_interval_ms": 150,
                 "http_port": 0}
OPS_COMM = {"retry_policy": {"max_attempts": 3, "initial_backoff_ms": 100,
                             "max_backoff_ms": 500},
            # A TLS send is one frame and its ack, half-duplex.
            "timeout_in_ms": 120000,
            "messages_max_size_in_bytes": 0}
# The replay: the same job again in the same processes, on the CPU at this
# tree, which must give the same fault traces.
OPS_REPLAY = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=176,
                  seq=32, batch=2)
OPS_REPLAY_TIMEOUT_S = 3.0
# The fold is checked at these entries of every leaf: the first and last
# OPS_SAMPLE and OPS_SAMPLE seeded others (a CPU fold of the whole 1.36 GB
# tree takes about half a minute of the host's eight cores).
OPS_SAMPLE = 1 << 16
# Phase 13's join deadline (phase 13: 86.3 s).
OPS_JOIN_TIMEOUT_S = 240
# How long bob waits after his rounds for his pushes to be acknowledged:
# a TLS push of the flagship tree and its one crc resend.
OPS_SETTLE_S = 120.0


def ops_schedule(seed):
    return {"seed": seed, "rules": [
        {"fault": "partition", "src": "alice", "dst": "bob",
         "after": OPS_PARTITION_AFTER},
        {"fault": "corrupt", "src": "alice", "dst": "bob", "prob": 1.0,
         "after": OPS_CORRUPT_FRAME, "for": 1},
        {"fault": "corrupt", "src": "bob", "dst": "alice", "prob": 1.0,
         "after": OPS_CRC_FRAME, "for": 1},
        {"fault": "delay", "src": "alice", "prob": 0.4, "max_delay_ms": 40},
        {"fault": "drop", "src": "alice", "dst": "bob", "prob": 0.2},
    ]}


def _fold_sample_mismatches(contribs, agg, view, seed):
    """Entries of the card's aggregate ``agg`` whose bits differ from the
    CPU port's ``elastic_weighted_mean`` of the same contributions under
    the same liveness ``view``, at the first, last and
    ``OPS_SAMPLE`` seeded entries of each leaf: the fold is elementwise,
    so the CPU fold of those entries is the CPU fold's value there."""
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean
    from rayfed_tpu_torch.resilience.degraded import MISSING

    flat = {p: tree_util.tree_flatten(t)[0] for p, t in contribs.items()
            if t is not MISSING}
    gen = torch.Generator().manual_seed(seed)
    bad = 0
    for i, out in enumerate(tree_util.tree_flatten(agg)[0]):
        n = out.numel()
        idx = torch.cat([torch.arange(min(n, OPS_SAMPLE)),
                         torch.arange(max(0, n - OPS_SAMPLE), n),
                         torch.randint(0, n, (OPS_SAMPLE,), generator=gen)])
        dev_idx = idx.to(out.device)
        host = {p: {"x": leaves[i].reshape(-1)[dev_idx].cpu()}
                for p, leaves in flat.items()}
        want = elastic_weighted_mean(
            {p: host.get(p, MISSING) for p in contribs}, OPS_WEIGHTS,
            liveness=view)["x"]
        got = out.reshape(-1)[dev_idx].cpu()
        bad += int((_int_view(got) != _int_view(want)).sum())
    return bad


def _bits_flipped(a, b):
    """Per leaf, the bits that differ between trees ``a`` and ``b`` (on
    any device; only the differing entries come to the host)."""
    from rayfed_tpu_torch import tree_util

    out = []
    for x, y in zip(tree_util.tree_flatten(a)[0], tree_util.tree_flatten(b)[0]):
        xi, yi = _int_view(x.reshape(-1)), _int_view(y.reshape(-1))
        where = (xi != yi).nonzero().flatten()
        diff = (xi[where] ^ yi[where]).cpu().tolist()
        mask = (1 << (8 * x.element_size())) - 1
        out.append(sum(bin(d & mask).count("1") for d in diff))
    return out


def _series(metrics, name, **labels):
    """Sum of a registry snapshot's series ``name`` over the series whose
    labels include ``labels``."""
    ent = (metrics or {}).get(name) or {}
    return sum(s["value"] for s in ent.get("series", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


_OPS_SERIES = ("fed_resilience_injected_faults_total",
               "fed_transport_send_ops_total",
               "fed_transport_frame_crc_retransmits_total",
               "fed_transport_frame_crc_failures_total")


def _ops_counts(metrics):
    """What phase 13 reads of a party's registry snapshot: injected
    faults by kind, data frames sent, crc retransmits and failures."""
    faults = {s["labels"]["fault"]: s["value"] for s in
              (metrics.get(_OPS_SERIES[0]) or {}).get("series", [])}
    return dict(faults=faults, sends=_series(metrics, _OPS_SERIES[1]),
                retransmits=_series(metrics, _OPS_SERIES[2]),
                crc_failures=_series(metrics, _OPS_SERIES[3]))


def _cleanup_manager():
    """This party's tracker of the data pushes it has on the wire."""
    from rayfed_tpu_torch._private.global_context import get_global_context

    return get_global_context().get_cleanup_manager()


def _ops_program(party, addresses, device, cfg_kw, batch, seq, cert_dir,
                 seed, get_timeout_s, replay, replay_timeout_s):
    """Phase 13's party process: :func:`_ops_job` at ``cfg_kw``'s tree on
    ``device``, then, after ``fed.shutdown``, the same job again at
    ``replay``'s small tree on the CPU, with the same seed."""
    import gc

    import torch

    full = _ops_job(party, addresses, device, cfg_kw, batch, seq, cert_dir,
                    seed, get_timeout_s, "smoke-ops", True)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    small = {k: v for k, v in replay.items() if k not in ("seq", "batch")}
    again = _ops_job(party, addresses, "cpu", small, replay["batch"],
                     replay["seq"], cert_dir, seed, replay_timeout_s,
                     "smoke-ops-replay", False)
    return dict(full=full, replay=again)


def _ops_job(party, addresses, device, cfg_kw, batch, seq, cert_dir, seed,
             get_timeout_s, job_name, full):
    """One phase 13 job, the same driver in both parties: each round each
    party takes one bf16 step on its device, pushes its tree over TLS,
    and ``fed.get(on_missing="default")`` brings both trees; the
    survivors (arrived, and not DEAD in this party's liveness view) are
    folded by ``elastic_weighted_mean`` on the device, held bitwise
    against the CPU fold at sampled entries, and loaded into the
    trainer. After the rounds alice waits for her verdict on bob. Alice
    is the telemetry collector; with ``full`` she also reads its
    snapshot, its HTTP endpoint and its stitched trace, and flips her
    corrupted round's tree on the card to hold it against the CPU's
    flip."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import elastic_weighted_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.resilience.liveness import DEAD
    from rayfed_tpu_torch.telemetry import metrics as tm

    sys.path.insert(0, REPO)
    from tools.generate_tls_certs import tls_config_for

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    seeds = dict(PARTIES)
    names = [n for n, _ in PARTIES]
    root, other = names
    tracing.enable()
    fed.init(addresses=addresses, party=party, job_name=job_name,
             logging_level="warning",
             tls_config=tls_config_for(cert_dir, party),
             config={"barrier_on_initializing": True,
                     "cross_silo_comm": dict(OPS_COMM,
                                             frame_crc=party == other),
                     "resilience": {"fault_schedule": ops_schedule(seed),
                                    "liveness": OPS_LIVENESS},
                     "telemetry": OPS_TELEMETRY})

    @fed.remote
    class OpsTrainer:
        """One party's params and AdamW state on its device."""

        def __init__(self, name):
            init_fn, self.step_fn = make_fed_train_step(
                cfg, device, lr=1e-3, attn="flash")
            self.params, self.opt = init_fn(0)
            self.data = synthetic_lm_dataset(
                cfg.vocab, batch * (seq + 1), seq, seed=seeds[name])
            self.step_ms = []

        def train(self, r):
            blk = next(self.data.batches(batch, epoch=r))
            t = time.perf_counter()
            self.params, self.opt, loss = self.step_fn(
                self.params, self.opt, blk[:, :-1], blk[:, 1:])
            loss = float(loss)
            self.step_ms.append(1e3 * (time.perf_counter() - t))
            tree = tree_util.tree_map(lambda x: x.detach().clone(),
                                      self.params)
            return {"params": tree, "loss": loss, "t": time.time()}

        def load(self, agg):
            with torch.no_grad():
                for p, a in zip(tree_util.tree_flatten(self.params)[0],
                                tree_util.tree_flatten(agg)[0]):
                    p.copy_(a)

        def report(self):
            return dict(launches=dict(fa.LAUNCHES), step_ms=self.step_ms)

    @fed.remote
    def finish(trace, counts):
        return {"trace": trace, "counts": counts}

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    trainers = {n: OpsTrainer.party(n).remote(n) for n in names}
    timeout = get_timeout_s * (OPS_ROOT_WAIT if party == root else 1)
    rounds, kept = [], None
    for r in range(OPS_ROUNDS):
        t0 = time.perf_counter()
        handles = [trainers[n].train.remote(r) for n in names]
        # Round 0 also builds both trainers and compiles their first step.
        got = fed.get(handles, on_missing="default",
                      timeout=timeout * (OPS_ROOT_WAIT if r == 0 else 1))
        view = fed.liveness_view()
        contribs, rec = {}, dict(
            round=r, view=dict(view), missing=[], push=None,
            ids={n: h.get_fed_task_id() for n, h in zip(names, handles)})
        for n, v in zip(names, got):
            if v is fed.MISSING:
                contribs[n] = fed.MISSING
                rec["missing"].append(n)
                continue
            tree = v["params"]
            if n == party:
                rec["sent"] = _tree_digest(tree)
                if full and party == root and r == OPS_CORRUPT_FRAME:
                    kept = v
            else:
                nbytes = _tree_nbytes(tree)
                dec = _last_span("decode", nbytes)
                tree, info = _arrive(tree, device, v["t"])
                info.pop("arrived_at")
                info["key"] = None if dec is None else [
                    str(dec.upstream_seq_id), str(dec.downstream_seq_id)]
                rec["push"] = info
            contribs[n] = tree
        sync = torch.cuda.synchronize if on_cuda else (lambda: None)
        sync()
        t = time.perf_counter()
        agg = elastic_weighted_mean(contribs, OPS_WEIGHTS, liveness=view)
        sync()
        rec["fold_ms"] = 1e3 * (time.perf_counter() - t)
        rec["survivors"] = sorted(
            n for n in names if contribs[n] is not fed.MISSING
            and view.get(n) != DEAD)
        rec["fold_mismatched"] = _fold_sample_mismatches(contribs, agg,
                                                         view, seed + r)
        for n in names:
            trainers[n].load.remote(agg)
        del contribs, agg, got
        rec["wall_s"] = time.perf_counter() - t0
        rounds.append(rec)
    dead_wait = None
    if party == root:
        # The cut has been live since alice's OPS_PARTITION_AFTER-th
        # frame; her monitor must reach its verdict.
        t = time.monotonic()
        while (fed.party_state(other) != DEAD
               and time.monotonic() - t < OPS_DEAD_WAIT_S):
            time.sleep(0.05)
        dead_wait = time.monotonic() - t
    reports = [trainers[n].report.remote() for n in names]
    if party == other:
        # His last round ends at its get's timeout (alice's push there is
        # dropped), while his own push of that round may still be on the
        # wire: the crc resend is counted when alice's NACK comes back.
        # His counts are read once every push of his has resolved.
        require(_cleanup_manager().wait_for_inflight(OPS_SETTLE_S),
                f"{other}'s pushes were not all acknowledged "
                f"{OPS_SETTLE_S:.0f} s after his last round")
    # Bob's last word rides the direction the cut leaves open: his fault
    # trace and counts, which alice holds the collector's view against.
    done = finish.party(other).remote(
        fed.fault_trace(), _ops_counts(tm.get_registry().snapshot()))
    out = dict(party=party, rounds=rounds, trace=fed.fault_trace(),
               final=fed.get(done), dead_wait_s=dead_wait,
               view=dict(fed.liveness_view()), spans=_push_spans(),
               report=fed.get(reports[names.index(party)]),
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if on_cuda else None))
    if full and party == root:
        out["collector"] = _ops_collector(out["trace"], out["final"])
        out["corrupt"] = _ops_card_corrupt(kept, out["trace"], seed)
    del kept, trainers
    fed.shutdown()
    return out


def _ops_sender_spans(res):
    """A party's ``stage`` and ``send`` ms by the (up, down) seq ids of
    the frame, from its :func:`_push_spans`."""
    out = {}
    for kind, up, down, _, dur, _ in res["spans"]:
        if kind in ("stage", "send"):
            out.setdefault((up, down), {})[kind] = 1e3 * dur
    return out


def _ops_expected(traces, counts):
    """What the collector must show of each party, from its fault trace
    and its own counts: every probabilistic fault the trace records, as
    many as it records; at least the partitions it records (pings and
    telemetry pushes cut by a partition count too, untraced); at least
    its pushes that reached the wire; its crc retransmits, exactly."""
    want = {}
    for p, trace in traces.items():
        kinds = {}
        for e in trace:
            kinds[e["fault"]] = kinds.get(e["fault"], 0) + 1
        lost = kinds.get("drop", 0) + kinds.get("partition", 0)
        want[p] = dict(kinds=kinds, sends=OPS_ROUNDS - lost,
                       retransmits=counts[p]["retransmits"])
    return want


def _ops_collector_misses(seen, want):
    """Where the collector's counts ``seen`` fall short of ``want``."""
    misses = []
    for p, w in want.items():
        got = seen[p]
        for kind, n in w["kinds"].items():
            have = got["faults"].get(kind, 0)
            if have < n or (kind != "partition" and have != n):
                misses.append(f"{p} {kind} faults {have} vs trace {n}")
        if got["sends"] < w["sends"]:
            misses.append(f"{p} sends {got['sends']} < {w['sends']}")
        if got["retransmits"] != w["retransmits"]:
            misses.append(f"{p} crc retransmits {got['retransmits']} vs "
                          f"{w['retransmits']}")
    return misses


def _ops_collector(root_trace, final):
    """Alice's reading of her collector once bob's last word arrived: its
    fleet snapshot (polled until it holds what both traces record, at
    most 20 s), ``/metrics`` off its HTTP endpoint, and the stitched
    fleet trace."""
    import urllib.request

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import telemetry
    from rayfed_tpu_torch.telemetry import metrics as tm

    root, other = (n for n, _ in PARTIES)
    counts = {root: _ops_counts(tm.get_registry().snapshot()),
              other: final["counts"]}
    want = _ops_expected({root: root_trace, other: final["trace"]}, counts)
    deadline = time.monotonic() + 20
    while True:
        snap = fed.telemetry_snapshot()
        seen = {p: _ops_counts(snap["parties"].get(p, {}).get("metrics", {}))
                for p in (root, other)}
        if not _ops_collector_misses(seen, want) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    with urllib.request.urlopen(telemetry.http_url() + "/metrics",
                                timeout=10) as resp:
        text = resp.read().decode("utf-8")
    fleet = fed.export_fleet_trace()
    stitched = [e for e in fleet["edges"]
                if len({ev["party"] for ev in e["events"]}) >= 2]
    return dict(
        seen=seen, counts=counts,
        pushes={p: snap["parties"][p]["pushes"] for p in (root, other)},
        endpoint=telemetry.http_url(),
        metrics_parties=[p for p in (root, other) if f'party="{p}"' in text],
        metrics_series=sum(1 for line in text.splitlines()
                           if line and not line.startswith("#")),
        edges=len(fleet["edges"]), stitched=len(stitched),
        stitched_kinds=sorted({ev["kind"] for e in stitched
                               for ev in e["events"]}))


def _ops_card_corrupt(kept, trace, seed):
    """Alice's corrupted push, flipped again where it lives (her device)
    and on the CPU by the port's injector with the frame's seq ids from
    her fault trace: the bits each leaf lost, whether the flipped copy
    stayed on the device, and both copies' digests."""
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.resilience.inject import _corrupt_value

    root, other = (n for n, _ in PARTIES)
    (e,) = [e for e in trace if e["fault"] == "corrupt"]
    on_dev = _corrupt_value(kept, seed, root, other, e["up"], e["down"])
    host = dict(kept, params=tree_util.tree_map(lambda x: x.cpu(),
                                                kept["params"]))
    on_cpu = _corrupt_value(host, seed, root, other, e["up"], e["down"])
    leaves = tree_util.tree_flatten(on_dev["params"])[0]
    device = tree_util.tree_flatten(kept["params"])[0][0].device
    return dict(bits=_bits_flipped(kept["params"], on_dev["params"]),
                stays=all(x.device == device for x in leaves),
                device=str(device),
                card=_tree_digest(on_dev["params"]),
                cpu=_tree_digest(on_cpu["params"]))


def phase_ops(device, cfg, *, batch, seq, label="", replay=OPS_REPLAY,
              get_timeout_s=OPS_GET_TIMEOUT_S,
              replay_timeout_s=OPS_REPLAY_TIMEOUT_S,
              timeout_s=OPS_JOIN_TIMEOUT_S):
    """Phase 13: :func:`_ops_program` in two spawned party processes over
    TLS (certificates from ``tools/generate_tls_certs.py``): the job at
    ``cfg``'s tree on ``device``, then the same job with the same seed
    at ``replay``'s small tree on the CPU; checked: (a) bob ends DEAD in
    alice's liveness view; (b) every round's fold on the device is
    bitwise the CPU fold of the same survivors (sampled entries of every
    leaf); (c) alice's corrupted push reached bob with exactly one bit
    of each leaf flipped, the bit the CPU injector picks, and the same
    flip on the device stays there and gives the CPU's bits; (d) every
    other push arrived bitwise as its owner hashed it, bob's crc-tainted
    one after its resend, and bob missed exactly the pushes alice's
    trace drops or cuts; (e) each party's fault trace is byte-identical
    in the two jobs; (f) the collector's snapshot counts what each
    party's fault trace records, its sends and bob's crc retransmit; (g)
    ``/metrics`` serves both parties' series; (h)
    ``fed.export_fleet_trace()`` stitches edges across both parties; (i)
    on the card, each party's steps launched every bf16 kernel. Prints
    the round walls, each TLS push's ms, GB/s and split, the step and
    fold ms, each party's peak memory. Returns both parties' results of
    the first job."""
    import dataclasses

    import torch

    from tools.generate_tls_certs import generate

    root, other = (n for n, _ in PARTIES)
    with tempfile.TemporaryDirectory() as certs:
        generate(certs, [root, other])
        print(f"[ops] {label} TLS on (certificates from "
              f"tools/generate_tls_certs.py), telemetry collector {root}, "
              f"fault seed {OPS_SEED}")
        results, wall = spawn_parties(
            _ops_program, (device, dataclasses.asdict(cfg), batch, seq,
                           certs, OPS_SEED, get_timeout_s, replay,
                           replay_timeout_s), timeout_s)
    full = {p: res["full"] for p, res in results.items()}
    again = {p: res["replay"] for p, res in results.items()}
    a, b = full[root], full[other]

    require(a["view"].get(other) == "DEAD",
            f"(a) {other} is not DEAD in {root}'s view after "
            f"{a['dead_wait_s']:.1f} s: {a['view']}")
    for p, res in full.items():
        for rec in res["rounds"]:
            require(rec["fold_mismatched"] == 0,
                    f"(b) {p} round {rec['round']}: {rec['fold_mismatched']} "
                    f"sampled entries of the device's fold differ from the "
                    f"CPU fold")
    cut = sorted({e["up"] for e in a["trace"]
                  if e["fault"] in ("drop", "partition")})
    bob_missed = sorted(rec["ids"][root] for rec in b["rounds"]
                        if rec["missing"])
    require(bob_missed == cut and all(
        rec["missing"] == [root] for rec in b["rounds"] if rec["missing"]),
        f"(d) {other} missed {root}'s pushes {bob_missed}, but {root}'s "
        f"trace drops or cuts {cut}")
    require(not any(rec["missing"] for rec in a["rounds"]),
            f"(d) {root} missed a push of {other}'s")
    corrupt = a["corrupt"]
    for r, rec in enumerate(b["rounds"]):
        if rec["push"] is None:
            continue
        sent = a["rounds"][r]["sent"]
        if r == OPS_CORRUPT_FRAME:
            require(rec["push"]["digest"] == corrupt["cpu"]
                    and rec["push"]["digest"] != sent,
                    f"(c) {other} did not receive {root}'s round {r} push "
                    f"as the CPU injector flips it")
        else:
            require(rec["push"]["digest"] == sent,
                    f"(d) {root}'s round {r} push arrived with other bytes")
    require(all(n == 1 for n in corrupt["bits"]) and corrupt["stays"]
            and corrupt["card"] == corrupt["cpu"],
            f"(c) the flip of {root}'s push on {corrupt['device']}: bits per "
            f"leaf {corrupt['bits']}, stayed there {corrupt['stays']}, equal "
            f"to the CPU's {corrupt['card'] == corrupt['cpu']}")
    for r, rec in enumerate(a["rounds"]):
        require(rec["push"]["digest"] == b["rounds"][r]["sent"],
                f"(d) {other}'s round {r} push arrived with other bytes")
    for p in (root, other):
        require(json.dumps(full[p]["trace"], sort_keys=True)
                == json.dumps(again[p]["trace"], sort_keys=True),
                f"(e) {p}'s fault trace differs between the two jobs of "
                f"seed {OPS_SEED}: {full[p]['trace']} vs {again[p]['trace']}")
    kinds = {e["fault"] for e in a["trace"]}
    require({"partition", "corrupt"} <= kinds and any(
        e["fault"] == "corrupt" for e in b["trace"]),
        f"(e) the traces miss faults the schedule sets: {a['trace']}, "
        f"{b['trace']}")
    col = a["collector"]
    want = _ops_expected({root: a["trace"], other: b["trace"]},
                         col["counts"])
    require(want[other]["retransmits"] >= 1,
            f"(f) {other}'s crc-tainted push was never resent: "
            f"{col['counts'][other]}")
    misses = _ops_collector_misses(col["seen"], want)
    require(not misses, f"(f) the collector's snapshot falls short of the "
                        f"fault traces: {misses}")
    require(col["seen"][root]["crc_failures"] >= 1,
            f"(f) the collector shows no crc failure at {root}: "
            f"{col['seen'][root]}")
    require(col["metrics_parties"] == [root, other],
            f"(g) /metrics at {col['endpoint']} serves series of "
            f"{col['metrics_parties']} only")
    require(col["stitched"] > 0 and "send" in col["stitched_kinds"],
            f"(h) the fleet trace stitched no edge across both parties "
            f"({col['edges']} edges)")
    if torch.device(device).type == "cuda":
        for p, res in full.items():
            require(all(res["report"]["launches"][k] > 0
                        for k in BF16_KERNELS),
                    f"(i) {p}'s steps did not launch every bf16 kernel: "
                    f"{res['report']['launches']}")

    def ms(v):
        return "not measured" if v is None else f"{v:.1f} ms"

    print(f"[ops] {label} two party processes, {OPS_ROUNDS} rounds, then "
          f"the replay at {replay} on the CPU, in {wall:.1f} s from spawn "
          f"to exit; {other} DEAD in {root}'s view {a['dead_wait_s']:.2f} "
          f"s after her last round")
    print(f"[ops] {label} {root}'s fault trace "
          f"{json.dumps(a['trace'], sort_keys=True)}; {other}'s "
          f"{json.dumps(b['trace'], sort_keys=True)} (both jobs)")
    for p, q in ((root, other), (other, root)):
        sender = _ops_sender_spans(full[q])
        for rec in full[p]["rounds"]:
            push = rec["push"]
            parts = [f"{q}->{p} round {rec['round']}: wall "
                     f"{rec['wall_s']:.2f} s, fold {rec['fold_ms']:.1f} ms "
                     f"over {rec['survivors']}"]
            if push is None:
                parts.append("push missing")
            else:
                total = push["push_ms"]
                stage = send = None
                if push["key"] is not None:
                    got = sender.get(tuple(push["key"]), {})
                    stage, send = got.get("stage"), got.get("send")
                rate = ("" if total is None else
                        f", {push['nbytes'] / total / 1e6:.3f} GB/s")
                parts.append(
                    f"TLS push {push['nbytes']} B: {ms(total)}{rate}; stage "
                    f"{ms(stage)}, send {ms(send)}, decode "
                    f"{ms(push['decode_ms'])}, place {ms(push['h2d_ms'])}")
            print(f"[ops] {label} " + "; ".join(parts))
    for p, res in full.items():
        steps = res["report"]["step_ms"]
        print(f"[ops] {label} party {p}: bf16 step ms by round "
              f"{[round(x, 1) for x in steps]} (the first builds the "
              f"step), launches "
              f"{res['report']['launches']}, max_memory_allocated "
              f"{res['max_memory_allocated']}")
    print(f"[ops] {label} collector at {root}: {json.dumps(col['seen'])}; "
          f"pushes taken {col['pushes']}; /metrics {col['metrics_series']} "
          f"series of {col['metrics_parties']}; fleet trace {col['edges']} "
          f"edges, {col['stitched']} across both parties "
          f"({col['stitched_kinds']})")
    print(f"[ops] {label} {root}'s corrupted push: one bit flipped in each "
          f"of {len(corrupt['bits'])} leaves, on {corrupt['device']} as on "
          f"the CPU")
    return full


def run_ops(smi):
    """Phase 13 at the flagship width, depth cut as phase 4's; returns the
    parties' bf16 kernel launches."""
    print("[ops] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}))
    t = _phase_begin(13)
    full = phase_ops("cuda", _flagship_cfg(PARTY_LAYERS),
                     batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                     label=f"on {smi}:")
    _phase_wall(13, t, smi)
    return {k: sum(res["report"]["launches"][k] for res in full.values())
            for k in BF16_KERNELS}


# ---------------------------------------------------------------------------
# Phase 14: the sharded train step and sharded decoding on a DeviceMesh
# ---------------------------------------------------------------------------

SHARDED_STEPS = 5
SHARDED_NEW_TOKENS = 4
MESH_NAMES = ["party", "data", "model"]


def _steps_on(step_fn, params, opt, blocks):
    """Steps over ``blocks``: losses, each step's ms (synchronized), the
    flash launches counted from zero, and the peak memory above what was
    allocated before (earlier trees stay resident)."""
    import torch

    from rayfed_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, ms = [], []
    for blk in blocks:
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, blk[:, :-1], blk[:, 1:])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    return dict(params=params, losses=losses, step_ms=ms,
                launches=dict(fa.LAUNCHES),
                peak_bytes=torch.cuda.max_memory_allocated() - base)


def _compare_trees(got, want):
    """(bitwise, largest absolute difference) of two plain trees."""
    import torch

    from rayfed_tpu_torch import tree_util

    pairs = [(a.detach(), b.detach()) for a, b in zip(
        tree_util.tree_flatten(got)[0], tree_util.tree_flatten(want)[0])]
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    return bitwise, diff


def phase_sharded(cfg, *, batch, seq, smi, steps=SHARDED_STEPS, lr=1e-3,
                  seed=PARTIES[0][1]):
    """Phase 14: ``make_fed_train_step`` over a party x data x model
    DeviceMesh of one rank (a one-process NCCL group on the card) against
    the one-device step, from the same seed on the same batches. (a)
    ``steps`` steps each: the losses and the params after them bitwise
    equal (the same kernels on the same shapes in the same order: on one
    rank every placement is the whole tensor and every collective is the
    identity); (b) the same with ``shard_opt_state=True`` and
    ``accum_steps=2`` against the one-device step with ``accum_steps=2``;
    (c) each run's K1-K3 launches, the sharded equal to the one-device
    ones; (d) step ms and peak memory of both; (e) greedy
    ``make_generate_fn(mesh=)`` of a few tokens from the trained params
    equal to the one-device tokens. Returns the sharded steps' launches."""
    import torch
    import torch.distributed as dist

    from rayfed_tpu_torch import mesh as pm
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.models import decode
    from rayfed_tpu_torch.parallel import sharding as shd
    from rayfed_tpu_torch.parallel.train import make_fed_train_step

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    launches = dict.fromkeys(BF16_KERNELS, 0)
    try:
        mesh = pm.build_mesh(mesh_shape=[1, 1, 1], axis_names=MESH_NAMES)
        print(f"[sharded] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
              f" over a {dist.get_backend()} group of "
              f"{dist.get_world_size()}")
        data = synthetic_lm_dataset(cfg.vocab, batch * steps * (seq + 1),
                                    seq, seed=seed)
        blocks = [torch.as_tensor(b, device="cuda").long()
                  for b in data.batches(batch, epoch=0)]
        require(len(blocks) == steps, f"{len(blocks)} batches, not {steps}")
        for part, kw in (("a", {}),
                         ("b", {"shard_opt_state": True, "accum_steps": 2})):
            one = make_fed_train_step(cfg, "cuda", lr=lr, attn="flash",
                                      **{k: v for k, v in kw.items()
                                         if k == "accum_steps"})
            sharded = make_fed_train_step(cfg, mesh, lr=lr, attn="flash",
                                          **kw)
            ref = _steps_on(one[1], *one[0](0), blocks)
            run = _steps_on(sharded[1], *sharded[0](0), blocks)
            bitwise, diff = _compare_trees(shd.gather_params(run["params"]),
                                           ref["params"])
            same_loss = run["losses"] == ref["losses"]
            print(f"[sharded] ({part}) {kw or 'replicated AdamW'}: losses "
                  f"{run['losses']} vs one device {ref['losses']}: "
                  f"{'bitwise' if same_loss else 'differ'}; params after "
                  f"{steps} steps {'bitwise' if bitwise else 'differ'} "
                  f"(largest difference {diff:.3e})")
            require(same_loss and bitwise,
                    f"({part}) sharded step differs from the one-device "
                    f"step: losses {run['losses']} vs {ref['losses']}, "
                    f"largest param difference {diff:.3e}")
            got = {k: run["launches"][k] for k in BF16_KERNELS}
            want = {k: ref["launches"][k] for k in BF16_KERNELS}
            require(got == want and all(got.values()),
                    f"({part}) K1-K3 launches {got} vs one device {want}")
            for k in BF16_KERNELS:
                launches[k] += got[k]
            med = statistics.median(run["step_ms"][1:])
            ref_med = statistics.median(ref["step_ms"][1:])
            print(f"[sharded] ({part}) launches {got} (one device {want}); "
                  f"step median {med:.1f} ms vs one device {ref_med:.1f} ms "
                  f"({(med / ref_med - 1) * 100:+.1f} %); peak memory above "
                  f"resident {run['peak_bytes'] / 1e9:.2f} GB vs "
                  f"{ref['peak_bytes'] / 1e9:.2f} GB; on {smi}")
            trained = ref["params"]
            del one, sharded, run, ref
            torch.cuda.empty_cache()
        prompt = blocks[0][:2, :64]
        want = decode.make_generate_fn(
            cfg, max_new_tokens=SHARDED_NEW_TOKENS)(trained, prompt)
        got = decode.make_generate_fn(
            cfg, max_new_tokens=SHARDED_NEW_TOKENS, mesh=mesh)(trained, prompt)
        require(torch.equal(got, want),
                f"(e) sharded greedy tokens {got[:, -SHARDED_NEW_TOKENS:]} "
                f"vs one device {want[:, -SHARDED_NEW_TOKENS:]}")
        print(f"[sharded] (e) greedy tokens, mesh and one device: "
              f"{got[:, -SHARDED_NEW_TOKENS:].tolist()} (equal)")
    finally:
        dist.destroy_process_group()
    return launches


def run_sharded(smi):
    """Phase 14 at the flagship width, depth cut as phase 4's."""
    print("[sharded] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], SMOKE_LAYERS]}))
    t = _phase_begin(14)
    launches = phase_sharded(_flagship_cfg(SMOKE_LAYERS),
                             batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                             smi=smi)
    _phase_wall(14, t, smi)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: a party over two processes (multi-process parties)
# ---------------------------------------------------------------------------

#: The receive deadline of phase 15's job, which the relay and the party
#: group take too (ms).
MULTIPROC_RECV_MS = 60_000
# Phase 15's join deadline (phase 15: 46.1 s).
MULTIPROC_TIMEOUT_S = 135
# Phase 15's data-parallel loss against the one-process step's: the CPU
# tests' tolerance (tests/test_torch_multihost_party.py), rtol and atol.
MULTIPROC_LOSS_TOL = 1e-5
# Phase 15's data-parallel gradient against the one-process step's, read
# from each leaf's first AdamW moment (0.1 g after one step): the largest
# ||m_dp - m_one|| / ||m_one|| over the leaves. The two steps round their
# bf16 gradients in other orders (two halves summed over gloo against one
# batch), a few units of bf16's 2^-8 at most; a reduction that returns
# one process's gradient, or the sum for the mean, is off by 0.3 to 1.
MULTIPROC_MOMENT_TOL = 2e-2
MULTIPROC_COMM = dict(FED_COMM, recv_timeout_in_ms=MULTIPROC_RECV_MS,
                      continue_waiting_for_data_sending_on_error=True)


def _moment_errors(params, opt, params_one, opt_one):
    """{leaf path: ||m - m_one|| / ||m_one||} of the first AdamW moments
    of two steps' optimizers over the same tree (the data-parallel one's
    moments may be replicated DTensors)."""
    import torch
    from torch.distributed.tensor import DTensor

    from rayfed_tpu_torch.parallel.sharding import leaf_paths

    out = {}
    for (path, p), (_, q) in zip(leaf_paths(params), leaf_paths(params_one)):
        m = opt.state[p]["exp_avg"]
        m = (m.to_local() if isinstance(m, DTensor) else m).float()
        m1 = opt_one.state[q]["exp_avg"].float()
        out[path] = float(
            torch.linalg.vector_norm(m - m1)
            / torch.linalg.vector_norm(m1).clamp_min(1e-30))
    return out


def _plain_digest(tree):
    """:func:`_tree_digest` of a tree whose leaves may be replicated
    DTensors (each process's local copy is the whole leaf)."""
    from torch.distributed.tensor import DTensor

    from rayfed_tpu_torch import tree_util

    return _tree_digest(tree_util.tree_map(
        lambda x: x.to_local() if isinstance(x, DTensor) else x, tree))


def _multiproc_program(party, addresses, device, cfg_kw, batch, seq,
                       coordinator, pid=0):
    """Phase 15's driver, the same in every process: alice runs as two
    processes (``pid`` 0, the leader, and 1) joined by
    ``config["jax_distributed"]`` with a ``data = 2`` party mesh, bob as
    one. Returns what the parent checks (a)-(f) and prints."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import mesh as fed_mesh
    from rayfed_tpu_torch import tracing, tree_util
    from rayfed_tpu_torch.data import synthetic_lm_dataset
    from rayfed_tpu_torch.exceptions import FedRemoteError
    from rayfed_tpu_torch.federated import fed_aggregate
    from rayfed_tpu_torch.models import transformer as tfm
    from rayfed_tpu_torch.ops import flash_attention as fa
    from rayfed_tpu_torch.ops.aggregate import tree_mean
    from rayfed_tpu_torch.parallel.train import make_fed_train_step
    from rayfed_tpu_torch.proxy import barriers

    cfg = tfm.TransformerConfig(**cfg_kw)
    on_cuda = torch.device(device).type == "cuda"
    config = {"cross_silo_comm": MULTIPROC_COMM}
    if party == "alice":
        config["jax_distributed"] = {"coordinator_address": coordinator,
                                     "num_processes": 2, "process_id": pid}
        config["party_mesh"] = {"mesh_shape": [2], "axis_names": ["data"]}
        if not on_cuda:
            config["party_mesh"]["device_type"] = "cpu"
    tracing.enable()
    fed.init(addresses=addresses, party=party, logging_level="warning",
             transport="cuda" if on_cuda else "tcp", config=config)
    dev = fed_mesh.get_party_device() or torch.device(device)
    out = dict(party=party, pid=pid)
    if party == "alice":
        out["backend"] = fed_mesh.party_group()["backend"]

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    @fed.remote
    def dp_step():
        """(a) One data-parallel step over the party mesh, each process on
        its half of phase 4's batch; then, at the leader, the one-process
        step over the whole batch from the same params."""
        blk = torch.as_tensor(next(synthetic_lm_dataset(
            cfg.vocab, batch * (seq + 1), seq, seed=1).batches(batch)))
        x, y = blk[:, :-1], blk[:, 1:]
        init_fn, step_fn = make_fed_train_step(
            cfg, fed_mesh.get_party_mesh(), lr=1e-3, attn="flash")
        params, opt = init_fn(0)
        fa.reset_launch_counts()
        sync()
        t = time.perf_counter()
        params, opt, loss = step_fn(params, opt, x, y)
        loss = float(loss)
        sync()
        step_ms = 1e3 * (time.perf_counter() - t)
        launches = dict(fa.LAUNCHES)
        res = dict(loss=loss, step_ms=step_ms, launches=launches,
                   replicated=all(
                       isinstance(p, DTensor) and all(
                           isinstance(q, Replicate) for q in p.placements)
                       for p in tree_util.tree_flatten(params)[0]))
        if pid == 0:
            init1, step1 = make_fed_train_step(cfg, dev, lr=1e-3,
                                               attn="flash")
            p1, o1 = init1(0)
            p1, o1, loss1 = step1(p1, o1, x.to(dev), y.to(dev))
            res["one_process_loss"] = float(loss1)
            res["moment_err"] = _moment_errors(params, opt, p1, o1)
            del p1, o1
        res["digest"] = _plain_digest(params)
        return res, params

    @fed.remote
    def bob_tree():
        return tfm.init_params(2, cfg, dev)

    @fed.remote
    def digest(tree):
        return _plain_digest(tree)

    @fed.remote
    def held(tree):
        """(c) Where bob's tree landed in this process, and its bytes."""
        leaves = tree_util.tree_flatten(tree)[0]
        return dict(digest=_plain_digest(tree), placed=sorted({
            f"{type(x).__name__}:{x.device.type}:"
            + ",".join(type(p).__name__ for p in getattr(x, "placements",
                                                           ()))
            for x in leaves}))

    @fed.remote
    def cpu_fold(mine, theirs, agg):
        """(d) The aggregate against the CPU fold of the same trees."""
        def host(t):
            return tree_util.tree_map(
                lambda x: (x.to_local() if isinstance(x, DTensor) else x)
                .detach().cpu(), t)
        want = tree_mean(host(mine), host(theirs))
        got = host(agg)
        return sum(int((_int_view(a) != _int_view(b)).sum()) for a, b in zip(
            tree_util.tree_flatten(got)[0], tree_util.tree_flatten(want)[0]))

    @fed.remote
    def boom():
        raise ValueError("bob's task failed on purpose")

    @fed.remote
    def after(x):
        return x

    step, mine = dp_step.party("alice").options(num_returns=2).remote()
    out["step"] = fed.get(step)
    # (b) alice's tree to bob: the leader's push, the follower's none.
    out["pushed_digest"] = fed.get(digest.party("bob").remote(mine))
    # (c) bob's tree to both of alice's processes.
    theirs = bob_tree.party("bob").remote()
    out["bob_digest"] = fed.get(digest.party("bob").remote(theirs))
    out["held"] = fed.get(held.party("alice").remote(theirs))
    # (d) the aggregate at alice, in both processes, and the CPU fold.
    agg = fed_aggregate({"alice": mine, "bob": theirs}, op="mean")
    out["agg_digest"] = fed.get(digest.party("alice").remote(agg))
    out["fold_mismatched"] = fed.get(cpu_fold.party("alice").remote(
        mine, theirs, agg))
    if party == "bob":
        frames = [(s.upstream_seq_id, s.downstream_seq_id)
                  for s in tracing.get_spans("decode") if s.peer == "alice"]
        out["frames"] = dict(n=len(frames), edges=len(set(frames)))
    # (e) an error at bob reaches both of alice's processes.
    try:
        fed.get(after.party("alice").remote(boom.party("bob").remote()))
        out["remote_error"] = None
    except FedRemoteError as e:
        out["remote_error"] = ["FedRemoteError", str(e)]
    except ValueError as e:
        out["remote_error"] = ["ValueError", str(e)]
    out["relay"] = barriers.relay_stats()
    if party == "alice":
        # (f) every follower's gets have returned, so each has acked.
        dist.monitored_barrier(timeout=timedelta(seconds=DIST_TIMEOUT_S))
        if pid == 0:
            out["keys_left"] = barriers.relay_keys_left()
    fed.shutdown()
    # The party group outlives fed.shutdown; this process is done with it.
    fed_mesh.shutdown_distributed()
    return out


def phase_multiproc(device, cfg, *, batch, seq, label="",
                    timeout_s=MULTIPROC_TIMEOUT_S):
    """Phase 15: :func:`_multiproc_program` in three spawned processes,
    alice's two one party over a party group (gloo: they share the one
    card), bob's one; checked: (a) each of alice's processes' step
    launched K1-K3 and left params bitwise equal to the other's, whose
    loss is within ``MULTIPROC_LOSS_TOL`` and whose gradient (each leaf's
    first AdamW moment) is within ``MULTIPROC_MOMENT_TOL`` in relative
    norm of a one-process step over the whole batch; (b) bob got alice's tree bitwise, one frame an edge from
    alice; (c) both of alice's processes hold bob's tree bitwise as bob
    hashed it, placed on the card (replicated DTensors on the data mesh);
    (d) the aggregate is the same in both of alice's processes and
    bitwise the CPU fold; (e) bob's error reaches both as
    ``FedRemoteError``; (f) no relay key is left in the party's store.
    Prints the relay's ms and GB/s (and the leader's encode and hand-on
    ms) and each process's step ms. Returns
    the bf16 kernels' launches of both of alice's steps."""
    import dataclasses

    import torch

    coordinator = f"127.0.0.1:{_free_port()}"
    results, wall = spawn_parties(
        _multiproc_program, (device, dataclasses.asdict(cfg), batch, seq,
                             coordinator), timeout_s, names=["alice", "bob"],
        processes={"alice": [(0,), (1,)]})
    leader, follower = results["alice"]
    bob = results["bob"]
    alice = (leader, follower)
    on_card = torch.device(device).type == "cuda"
    for r in alice:
        # Both processes on the one card (or the CPU): NCCL refuses two
        # ranks on one card.
        require(r["backend"] == "gloo",
                f"alice's party group runs {r['backend']}, not gloo")
        if on_card:
            require(all(r["step"]["launches"][k] > 0 for k in BF16_KERNELS),
                    f"(a) alice process {r['pid']}'s step did not launch "
                    f"every bf16 kernel: {r['step']['launches']}")
        require(r["step"]["replicated"],
                f"(a) process {r['pid']}'s params are not replicated DTensors")
    require(leader["step"]["digest"] == follower["step"]["digest"],
            "(a) alice's two processes hold different params after the step")
    require(leader["step"]["loss"] == follower["step"]["loss"],
            "(a) alice's two processes disagree on the step's loss")
    one = leader["step"]["one_process_loss"]
    dp = leader["step"]["loss"]
    require(abs(dp - one) <= MULTIPROC_LOSS_TOL * (1 + abs(one)),
            f"(a) the data-parallel loss {dp!r} is not within "
            f"{MULTIPROC_LOSS_TOL} of the one-process step's {one!r}")
    moments = leader["step"]["moment_err"]
    worst = max(moments, key=moments.get)
    require(moments[worst] <= MULTIPROC_MOMENT_TOL,
            f"(a) the data-parallel gradient (first AdamW moment) of "
            f"{worst} is {moments[worst]:.3e} off the one-process step's "
            f"(relative norm; at most {MULTIPROC_MOMENT_TOL})")
    for r in (leader, follower, bob):
        require(r["pushed_digest"] == leader["step"]["digest"],
                f"(b) bob's copy of alice's tree differs from hers "
                f"({r['party']} {r['pid']})")
    require(bob["frames"]["n"] == bob["frames"]["edges"] > 0,
            f"(b) bob decoded {bob['frames']['n']} frames from alice over "
            f"{bob['frames']['edges']} edges: a follower sent one")
    for r in alice:
        require(r["held"]["digest"] == bob["bob_digest"],
                f"(c) alice process {r['pid']} holds other bytes of bob's "
                "tree than bob hashed")
        want = [f"DTensor:{'cuda' if on_card else 'cpu'}:Replicate"]
        require(r["held"]["placed"] == want,
                f"(c) alice process {r['pid']} holds bob's tree as "
                f"{r['held']['placed']}, not {want}")
        require(r["agg_digest"] == leader["agg_digest"],
                "(d) alice's two processes hold different aggregates")
        require(r["fold_mismatched"] == 0,
                f"(d) the aggregate differs from the CPU fold in "
                f"{r['fold_mismatched']} elements (process {r['pid']})")
        require(r["remote_error"] and r["remote_error"][0] == "FedRemoteError",
                f"(e) bob's error reached alice process {r['pid']} as "
                f"{r['remote_error']}")
    require(leader["keys_left"] == [],
            f"(f) relay keys left in the party's store: "
            f"{leader['keys_left']}")
    relays = [x for x in follower["relay"] if x["role"] == "follower"]
    big = max(relays, key=lambda x: x["nbytes"])
    # The leader encodes the value it received, on its receive callback
    # before its own consumer gets it, then hands the bytes to the store
    # or the bulk group: both delay the leader's copy of the task.
    pub = [x for x in leader["relay"]
           if x["role"] == "leader" and x["key"] == big["key"]]
    require(len(pub) == 1, f"(c) the leader published {big['key']} "
            f"{len(pub)} times")
    print(f"[multiproc] {label} alice over two processes ({leader['backend']}"
          f" party group), bob one; {wall:.1f} s from spawn to exit")
    print(f"[multiproc] {label} (a) data-parallel step (data = 2, {batch} "
          f"rows, each process half): ms {leader['step']['step_ms']:.1f} / "
          f"{follower['step']['step_ms']:.1f}, loss {dp:.6f} against the "
          f"one-process step's {one:.6f}; first AdamW moment off the "
          f"one-process step's by at most {moments[worst]:.3e} ({worst}, "
          f"relative norm, {len(moments)} leaves); bf16 launches "
          f"{[{k: r['step']['launches'][k] for k in BF16_KERNELS} for r in alice]}")
    print(f"[multiproc] {label} (c) relay of bob's tree to the follower: "
          f"{big['nbytes']} B in {big['relay_ms']:.1f} ms "
          f"({big['nbytes'] / big['relay_ms'] / 1e6:.3f} GB/s, from the "
          f"leader's encode to the bytes at the follower; the follower "
          f"waited and received for {big['get_ms']:.1f} ms, decoded and "
          f"placed in {big['decode_ms']:.1f} ms; the leader encoded it in "
          f"{pub[0]['encode_ms']:.1f} ms and handed it on in "
          f"{pub[0]['set_ms']:.1f} ms); {len(relays)} values relayed, "
          f"{sum(x['nbytes'] for x in relays)} B in all")
    print(f"[multiproc] {label} (b) bob decoded {bob['frames']['n']} frames "
          f"from alice over {bob['frames']['edges']} edges; (d) aggregate "
          f"bitwise the CPU fold in both processes; (e) {leader['remote_error']}"
          f"; (f) no relay key left")
    return {k: leader["step"]["launches"][k] + follower["step"]["launches"][k]
            for k in BF16_KERNELS}


def run_multiproc(smi):
    """Phase 15 at the flagship width, depth PARTY_LAYERS."""
    print("[multiproc] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}))
    t = _phase_begin(15)
    launches = phase_multiproc("cuda", _flagship_cfg(PARTY_LAYERS),
                               batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                               label=f"on {smi}:")
    _phase_wall(15, t, smi)
    return launches


def _flagship_cfg(n_layers, shape=FLAGSHIP):
    from rayfed_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(
        vocab=shape["vocab"], d_model=shape["d_model"],
        n_heads=shape["n_heads"], n_layers=n_layers, d_ff=shape["d_ff"])


def run_family(smi):
    """Phase 9 at the flagship width, depth cut as phase 4's; (b), the
    LoRA program's party processes, at depth PARTY_LAYERS."""
    print("[family] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], SMOKE_LAYERS],
         "(b) n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}))
    t = _phase_begin(9)
    out = phase_family("cuda", _flagship_cfg(SMOKE_LAYERS),
                       batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                       label=f"on {smi}:",
                       lora_cfg=_flagship_cfg(PARTY_LAYERS))
    _phase_wall(9, t, smi)
    return out


def main(argv):
    import torch

    start_watchdog()
    t0 = _phase_begin(1)
    name, smi = phase_device()
    start_party_server()
    _phase_wall(1, t0, smi)
    if argv == ["--wide-only"]:
        # Phases 2 and 12 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_wide(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--multiproc-only"]:
        # Phases 2 and 15 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_multiproc(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--sharded-only"]:
        # Phases 2 and 14 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_sharded(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--ops-only"]:
        # Phases 2 and 13 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_ops(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--dma-only"]:
        # Phases 2 and 11 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_dma(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--privacy-only"]:
        # Phases 2 and 10 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_privacy(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--family-only"]:
        # Phases 2 and 9 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        run_family(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--async-only"]:
        # Phases 2 and 8 alone, in a fresh process (no kernel line).
        t = _phase_begin(2)
        phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
        _phase_wall(2, t, smi)
        t = _phase_begin(8)
        print("[async] reduced " + json.dumps(
            {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}))
        phase_async("cuda", _flagship_cfg(PARTY_LAYERS),
                    batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                    label=f"on {smi}:")
        _phase_wall(8, t, smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    if argv == ["--serving-only"]:
        # Phase 7 alone, in a fresh process (no kernel line).
        phase_serving_all(_flagship_cfg(FLAGSHIP["n_layers"]), smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return
    require(not argv, f"unknown arguments {argv}; the options are "
                      "--serving-only, --async-only, --family-only, "
                      "--privacy-only, --dma-only, --wide-only, "
                      "--ops-only, --sharded-only and --multiproc-only")
    t = _phase_begin(2)
    phase_build(FLAGSHIP["d_model"] // FLAGSHIP["n_heads"])
    _phase_wall(2, t, smi)

    t = _phase_begin(3)
    kern = phase_kernels("cuda", FLAGSHIP["batch"], FLAGSHIP["seq"],
                         FLAGSHIP["n_heads"],
                         FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], smi)
    _phase_wall(3, t, smi)

    cfg = _flagship_cfg(SMOKE_LAYERS)
    reduced = {"n_layers": [FLAGSHIP["n_layers"], SMOKE_LAYERS]}
    print("[slice] reduced " + json.dumps(reduced))
    t = _phase_begin(4)
    summary = phase_slice("cuda", cfg, batch=FLAGSHIP["batch"],
                          seq=FLAGSHIP["seq"], label=f"on {smi}:")
    _phase_wall(4, t, smi)
    for kern_name in BF16_KERNELS:
        require(summary["launches"][kern_name] > 0,
                f"{kern_name} was not launched by the train steps: "
                f"{summary['launches']}")

    # Phase 4b, then phase 5 (two party processes on the same card): the
    # last phase's tensors are gone, and the allocator hands its cache
    # back first.
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print("[f32] reduced " + json.dumps(reduced))
    t = _phase_begin("4b")
    f32 = phase_f32("cuda", cfg, batch=FLAGSHIP["batch"], seq=FLAGSHIP["seq"],
                    label=f"on {smi}:")
    _phase_wall("4b", t, smi)
    for kern_name in F32_KERNELS:
        require(f32["launches"][kern_name] > 0,
                f"{kern_name} was not launched by the f32 steps: "
                f"{f32['launches']}")
    launches = {n: summary["launches"][n] for n in BF16_KERNELS}
    launches.update({n: f32["launches"][n] for n in F32_KERNELS})
    gc.collect()
    torch.cuda.empty_cache()
    party_cfg = _flagship_cfg(PARTY_LAYERS)
    reduced = {"n_layers": [FLAGSHIP["n_layers"], PARTY_LAYERS]}
    print("[fed] reduced " + json.dumps(reduced))
    t = _phase_begin(5)
    # The Python IO path's run repeats the native run's checks on one
    # round: it is there for the split beside the native one.
    fed = {io: phase_fed("cuda", party_cfg, batch=FLAGSHIP["batch"],
                         seq=FLAGSHIP["seq"], label=f"on {smi} ({io} IO):",
                         io_path=io, rounds=rounds)
           for io, rounds in (("native", FED_ROUNDS), ("python", 1))}
    compare_io_paths(fed)
    _phase_wall(5, t, smi)
    print("[programs] reduced " + json.dumps(reduced))
    t = _phase_begin(6)
    phase_programs("cuda", party_cfg, batch=FLAGSHIP["batch"],
                   seq=FLAGSHIP["seq"], label=f"on {smi}:")
    _phase_wall(6, t, smi)

    import dataclasses

    gc.collect()
    torch.cuda.empty_cache()
    t = _phase_begin(7)
    print("[serve] reduced " + json.dumps(
        {"n_layers": [FLAGSHIP["n_layers"], SERVE_LAYERS]}))
    phase_serving_all(dataclasses.replace(cfg, n_layers=SERVE_LAYERS), smi)
    _phase_wall(7, t, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print("[async] reduced " + json.dumps(reduced))
    t = _phase_begin(8)
    phase_async("cuda", party_cfg, batch=FLAGSHIP["batch"],
                seq=FLAGSHIP["seq"], label=f"on {smi}:")
    _phase_wall(8, t, smi)
    gc.collect()
    torch.cuda.empty_cache()
    family = run_family(smi)
    gc.collect()
    torch.cuda.empty_cache()
    push = fed["native"][PARTIES[0][0]]["rounds"][-1]["params_push"]
    privacy = run_privacy(smi, f32_push=push if push["push_ms"] else None)
    gc.collect()
    torch.cuda.empty_cache()
    dma = run_dma(smi, fed_push=push if push["push_ms"] else None)
    # The bf16 kernels' launches: phase 4's train steps, phase 9's MoE
    # steps (remat="attn"), phase 10's parties' steps in both of its jobs
    # and phase 11's parties' steps, each counted from zero.
    dma_reports = dma[PARTIES[0][0]]["reports"].values()
    for kern_name in BF16_KERNELS:
        launches[kern_name] += family["launches"][kern_name]
        launches[kern_name] += sum(r["launches"][kern_name]
                                   for r in privacy.values())
        launches[kern_name] += sum(r["dp"]["launches"][kern_name]
                                   for r in privacy.values())
        launches[kern_name] += sum(r["launches"][kern_name]
                                   for r in dma_reports)
    gc.collect()
    torch.cuda.empty_cache()
    # The D = 256 kernels: phase 12's train steps, bf16 in one process and
    # in the two parties, f32 in one process.
    wide_kern, wide_launches = run_wide(smi)
    kern.update(wide_kern)
    launches.update(wide_launches)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 13's parties' steps (bf16, D = 128).
    for kern_name, n in run_ops(smi).items():
        launches[kern_name] += n
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 14's sharded steps (bf16, D = 128), (a) and (b).
    for kern_name, n in run_sharded(smi).items():
        launches[kern_name] += n
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 15's data-parallel step in both of alice's processes.
    for kern_name, n in run_multiproc(smi).items():
        launches[kern_name] += n
    print(f"[total] {time.perf_counter() - t0:.1f} s (budget "
          f"{sum(PHASE_BUDGET_S.values())} s, watchdog {WATCHDOG_S} s) on "
          f"{smi}")

    line = []
    for k in KERNELS:
        r = kern[k["name"]]
        line.append(dict(k, launches=launches[k["name"]],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
