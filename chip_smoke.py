#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card and
``nvcc``.  In order, one line (or block) per phase:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the hand-written CUDA kernels built from ``src/repro_torch/kernels/csrc``
   (one nvcc process per source, all at once);
3. each kernel held against its plain PyTorch version on the card (the
   RCC kernels exactly; ``flash_attention`` within 1e-5 in float32 and
   3e-2 in bfloat16) at every main path's batched shapes and at edge cases
   (``lock_arbiter`` at G in {4, 64} configs x M in {480, 2400} requests,
   the gathers and the fused version read over G*262144 store rows), then,
   at each main path's shapes, its device time per call (calls captured in
   a CUDA graph, replayed between CUDA events), its time per call as the
   host issues them eagerly, its bound, the plain version's times and a
   library call's times (``flash_attention``: SDPA, at both serving
   paths' prefill calls, Dh = 64 and 128, at qwen2-vl-72b's (H = 64 after
   the GQA repeat, Dh = 128), at nemotron-4-15b's (H = 48; qwen2.5-32b's
   call is llama4-scout's and command-r-35b's qwen2-vl's), at
   whisper-small's two (the encoder's, not causal over 1500 frames, and
   the decoder's over a 224-token prompt) and at kimi-k2-1t-a32b's (B = 1,
   H = 64 after the GQA repeat, Dh = 112);
   ``multi_read``: the per-array ``a[keys]`` of the torch plane).  ``multi_read`` and
   ``mvcc_version_select`` are timed as the whole ops-level call
   (``ops.gather_many``, ``ops.version_read``), which must be one launch
   and no other device operation (read from a CUDA graph of one call), beside the earlier packed-table sequence for the same
   call rebuilt op for op with this tree's kernels; then batched ticks of each
   RCC main path (kernel plane: NOWAIT/SmallBank at G = 1, 4 and 64
   configs, MVCC/YCSB at G = 1 and 4; 10 ticks after 10 of warm-up) timed
   bare and traced with torch.profiler: wall time, device busy time, device operations,
   ``torch.cat`` launches and top-level host operations per batched tick;
4. the RCC main paths: ``repro_torch.api.run`` at the full ExperimentSpec
   defaults (4 nodes x 60 co-routines, 65536 records per node, 400 + 80
   ticks) for hybrid codes {0, 63, 21, 42} as ONE batched run on the
   ``"kernel"`` plane, with the kernels' launch counts per batched tick,
   for NOWAIT/SmallBank and then MVCC/YCSB (16-word records, 10 ops per
   txn, 4 version slots), then the same runs on the ``"torch"`` plane,
   whose counters must be equal, and both planes' counters against the JAX
   reference's golden files;
5. configs per second: NOWAIT/SmallBank hybrid 63 alone (G = 1) and its
   64 hybrid codes as one bucket (G = 64, against the reference's 64-code
   golden file), beside phase 4's G = 4;
6. CALVIN at the full spec on the kernel plane (smallbank, ycsb, tpcc, one
   bucket of the four codes each) against its golden file, and a profiled
   run of its batched epochs;
7. the node-sharded layouts, four node shards of one config on the one
   card (``devices=("cuda",) * 4``): NOWAIT/SmallBank, MVCC/YCSB and
   CALVIN/SmallBank hybrid 63 on ``layout="node"`` and the four codes on a
   2 x 2 ``config_node`` mesh, each against its golden file with the
   kernels' launches per tick, and the NOWAIT path's final store against
   the dense run's.  Before them, the kernel phase holds each RCC kernel at the
   node path's calls (``lock_arbiter`` on the coordinator over G*R global
   rows with requests at the shard boundaries; ``multi_read`` per shard
   with local keys outside [0, R_l) over G*R_l rows) against its plain
   version and the dense result, and times it there; the profile phase
   traces 10 node-layout ticks beside the dense tick at G = 1;
8. the legacy PRNG mode (``prng.threefry_partitionable(False)``, jax's
   ``jax_threefry_partitionable=False``) through the deprecated sweep entry
   points on the kernel plane: ``run_grid`` over the reference's pinned
   ``tests/data/stage_graph_golden.json`` (5 protocols x 4 codes on
   SmallBank, 4 protocols on YCSB, at its 2-node grid), NOWAIT/SmallBank and
   MVCC/YCSB at the full spec on CODES against ``golden_legacy_prng.json``
   with the torch plane's counters equal, and ``run_cell_sharded`` on four
   node shards of the one card for NOWAIT/SmallBank hybrid 63; each run's
   launches per tick checked and its wall printed, the full-size ones
   beside the same run in the default mode;
9. the LM serving path, stablelm-1.6b at full width in float32 with TF32
   off: ``init_lm`` from seed 0 on the card (checked against the reference's
   weights), a 2 x 256-token, 8-step run against the JAX reference's
   full-width golden file, a profiled prefill and decode step (device busy
   time and idle share), then the main path ``serve`` (4 prompts of 2048
   tokens, 32 tokens each) on the ``"kernel"`` plane, whose prefill must
   launch ``flash_attention`` once per layer, and on the ``"torch"`` plane,
   whose prefill logits and decided greedy tokens must agree;
10. the MoE serving path, llama4-scout-17b-a16e at full width, 2 of its 48
   layers (6.22 B float32 parameters), TF32 off: ``init_lm`` from seed 0
   on the card (checked against the reference's weights), the golden-file
   run on the first two layers of the same model (expert loads and dropped
   assignments per layer where the reference's router margin allows,
   logits and greedy tokens within 10x the port's CPU gap), a profiled
   prefill and decode step with the MoE layer's device time split into
   router, dispatch, expert products and combine, then the main path
   ``serve`` (4 x 2048 tokens, 32 each) on both planes, 2
   ``flash_attention`` launches per prefill, each plane's routing per layer;
11. the same model on a 1 x 4 mesh of shards on the one card, on phase 10's
   parameters (``sharding.AxisRules`` over ``launch.mesh.make_host_mesh(1,
   4, devices=("cuda",) * 4)``: the expert-parallel MoE, 4 experts a shard,
   and the sequence-sharded KV cache, through ``train.steps``' builders):
   the golden-file run on its first two layers through the mesh (routing,
   logits and decided tokens), then 4 x 2048 tokens x 32 with and without
   the mesh in turns (prefill and decode times, a profiled prefill and
   decode step's device busy and idle share, peak memory, 2
   ``flash_attention`` launches per prefill, the paths' logits; the mesh
   may not hold a second copy of a weight), then the dry run's 80 (arch x
   shape x mesh) cells on the logical production meshes;
12. the SSM serving path, falcon-mamba-7b at full width, 8 of its 64
   layers (1.38 B float32 parameters), TF32 off: ``init_lm`` from seed 0 on the
   card (checked against the reference's weights), the golden-file run on
   the first two layers of the same model (one 2048-token prompt, 8 greedy
   tokens, logits within 10x the port's CPU gap), a profiled prefill and
   decode step with the SSM layer's device time split into in_proj, conv,
   x_proj/dt, scan and out_proj, then the main path ``serve`` (4 x 2048
   tokens, 32 each) beside its float32 bound; it launches no hand-written
   kernel, and without attention both planes compute the same thing;
13. the hybrid serving path, recurrentgemma-2b at full width and all 26
   layers (3.31 B float32 parameters), TF32 off: ``init_lm`` from seed 0
   on the card (3,314,096,640 parameters, checked against the reference's
   weights, ``lam`` among them), the golden-file run on the first group of
   three layers (one 2048-token prompt, 8 greedy tokens, logits within 10x
   the port's CPU gap, every token equal), a profiled prefill and decode
   step with the RG-LRU layer's device time split into in/gate proj,
   conv, gates, scan and out_proj, then the main path ``serve`` (4 x 2048
   tokens, 32 each: the window's ring wraps) beside its float32 bound; it
   launches no hand-written kernel (local attention takes the reference's
   XLA route), and a torch-plane prefill gives its logits bitwise;
14. the encoder-decoder serving path, whisper-small at full width and depth
   (12 encoder and 12 decoder layers, 278,143,488 float32 parameters), TF32
   off: ``init_lm`` from seed 0 on the card (checked against the reference's
   weights, a cross-attention leaf among them, and the frames'
   ``normal(PRNGKey(1))`` draw), the golden-file run on the whole model (one
   request of 1500 frames and a 224-token prompt, 8 greedy tokens, logits
   within 10x the port's CPU gap, every token equal), a profiled prefill
   and decode step (``flash_attention`` launched 24 times in the prefill,
   not causal in the encoder, and never in decode), then the main path
   ``serve`` (4 x 1500 frames x 224 + 224 tokens) on both planes beside its
   float32 bounds;
15. the M-RoPE VLM serving path, qwen2-vl-72b at full width, 2 of its 80
   layers (4.25 B float32 parameters), TF32 off: ``init_lm`` from seed 0 on
   the card (its parameter count against the config's, checked against the
   reference's weights), the golden-file run on the two layers of the
   same model (one 2048-token request holding a 1 x 32 x 32 image grid at
   Qwen2-VL's three position ids, 8 greedy tokens whose positions run behind
   the cache length, logits within 10x the port's CPU gap, every decided
   token equal), a profiled prefill and decode step (``flash_attention``
   launched twice in the prefill and never in decode), then the main path
   ``serve`` (4 x 2048 tokens, 32 each, the reference's text-only positions)
   on both planes beside its float32 bounds;
16. the last three dense configs at full width, one after another, TF32
   off: nemotron-4-15b (2 of 32 layers, 3.93 B float32 parameters; squared
   ReLU, half of each head rotated), qwen2.5-32b (2 of 64 layers, 2.53 B;
   QKV biases, theta 1e6) and command-r-35b (2 of 40 layers, 3.51 B;
   parallel block, the head tied to the embedding, theta 8e6), each as
   phase 15: ``init_lm`` from seed 0 on the card (its parameter count
   against the config's, leaf corners against the reference's), the
   golden-file run on the model's first two layers (one 2048-token prompt,
   8 greedy tokens, logits within 10x the port's CPU gap), a profiled
   prefill and decode step (``flash_attention`` launched once a layer in
   the prefill and never in decode), then the main path ``serve`` (4 x 2048
   tokens, 32 each) on both planes beside its float32 bounds;
17. kimi-k2-1t-a32b at full width, 1 of its 61 layers (19.38 B float32
   parameters, 77.5 GB: 384 experts top-8, each expert leaf 5.64 B elements,
   drawn with 64-bit threefry counts), TF32 off: ``init_lm`` from seed 0 on
   the card (every leaf's sample and |w| sum, and raw windows of the expert
   leaves at their heads, around flat index 2**32 and at their tails,
   against the reference's), a profiled prefill and decode step
   (``flash_attention`` launched once in the prefill at Dh 112, never in
   decode), then the main path ``serve`` (1 x 2048 tokens, 32 each) on the
   kernel plane, whose first steps are the golden file's run (logits within
   10x the port's CPU gap, every decided token, layer 0's routing where the
   reference's margin allows), and on the torch plane;
18. the LM training path, stablelm-1.6b at full width in float32 with TF32
   off: 3 AdamW steps at the depth the reference's golden file was cut to
   (its pipeline tokens bitwise, losses, grad_norms and leaf sums within
   10x the port's CPU gap), then the main path at full width and depth,
   ``build_train_step`` on B = 4 x 2048 tokens for 5 AdamW steps (ms per
   step, tokens/s, peak memory, finite losses, step 0's loss against a
   torch-plane forward, one step profiled beside its bound; no hand-written
   kernel may launch: training takes the reference's XLA attention route),
   and a reduced ``TrainRunner`` whose injected failure leaves the loss
   stream of the run without it, bitwise;
19. the SSM, hybrid and encoder-decoder training paths at full width in
   float32 with TF32 off (``train families``): for falcon-mamba-7b,
   recurrentgemma-2b and whisper-small, each family's golden-file run (3
   AdamW steps at the cut its file states: tokens and whisper's frames
   bitwise, losses, grad_norms and leaf sums within 10x the port's CPU
   gap), then the main path, ``build_train_step`` for 4 AdamW steps under
   the config's ``remat`` (whisper-small whole at B = 8 x 448 with 1500
   frames; recurrentgemma-2b whole at 1 x 4096; falcon-mamba-7b cut to
   ``TRAIN_FAMILIES``' depth at 1 x 4096: ms per step, tokens/s, peak
   memory, one step profiled beside its bound, step 0's loss against a
   torch-plane forward; no hand-written kernel may launch), then
   whisper-small through ``python -m repro_torch.launch.train`` twice, the
   second run's injected failure leaving the first's losses, bitwise;
20. the M-RoPE VLM training path (``train vlm``), qwen2-vl-72b at full
   width, 1 of its 80 layers (3.37 B float32 parameters), TF32 off:
   ``init_lm`` from seed 0 on the card, the golden file's gradient of
   ``lm_loss`` on one 2048-token request holding a 1 x 32 x 32 image grid
   (M-RoPE's backward with three distinct position ids; loss, gradient norm
   and every leaf's sums within 10x the port's CPU gap, each gap printed
   beside its tolerance), then gradient accumulation: 3 AdamW steps of 2
   microbatches of 1 x 2048 (``TRAIN_VLM``) and one profiled beside its
   bound, step 0's loss against the mean of torch-plane forwards of the
   microbatches, ms per step, tokens/s, peak memory beside the float32
   copies the step holds; no hand-written kernel may launch;
21. the MoE training path on meshes of shards on the one card,
   llama4-scout-17b-a16e at full width, 1 of its 48 layers (4.15 B float32
   parameters), TF32 off: ``init_lm`` from seed 0 on the card, the mesh
   golden file's gradient of ``lm_loss`` (B = 2 x 512) on (1, 1), (1, 4)
   and (2, 2) (``devices=("cuda",) * 4``: the expert-parallel MoE, each
   data shard routing at its own capacity; loss, gradient norm and the sums
   of every gradient leaf within 10x the port's CPU gap, each data shard's
   loads and drops where the reference's router margin allows), then on
   each mesh 4 ``momentum_bf16`` steps of ``build_train_step(cfg, ...,
   shd=...)`` at B = 2 x 2048 (ms per step, tokens/s, peak memory beside
   the reckoned state, one profiled step's device busy time, idle share and
   operations, each beside the (1, 1) mesh's; no hand-written kernel may
   launch);
22. the user entry points at their own defaults, in process:
   ``examples/torch_quickstart.py`` (six protocol pairs and the hybrid MVCC
   at 4 nodes x 16 co-routines, 300 + 60 ticks; reduced qwen2.5-32b's
   forward and AdamW step), ``examples/torch_hybrid_search.py`` (SUNDIAL/
   SmallBank's 64 codes as one bucket, 160 + 80 ticks, and its ranking),
   ``examples/torch_txn_serving.py`` (the user-written admission workload
   under NOWAIT, then the reduced serve), ``examples/torch_train_lm.py`` (120
   reduced steps; ``--full`` for 120 steps with a failure at 70, held
   bitwise to the same run without it) and ``scripts/torch_dev_smoke.py
   --fast`` (the protocol matrix and all ten reduced archs), each against
   ``golden_examples.json``, the JAX reference's outputs at the same knobs;
   each path's launches counted and checked, the first calls of each input
   signature held to the kernels' plain versions (``KernelSpy``) and the
   most frequent one timed.

Every path's kernel launches are counted from 0 just before it runs and
read just after.  It prints each phase's wall seconds (``phase walls``),
then a JSON line of kernel measurements (each
kernel's times are the mean over its main-path launches; ``by_path`` holds
them per main path; ``library_ms`` is the mean over the paths that have a
library call, and ``ms_library_paths`` the kernel's own over those paths),
then, last, one JSON line
``{"ok": true, "device": {...}}``.  Any mismatch or fault raises: the exit
code is then not 0 and the last line is not printed.  Without CUDA it
exits 1 at once.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CODES = (0, 63, 21, 42)
# main paths, each ONE batched run of the four codes: (protocol, workload, golden file)
PATHS = (
    ("nowait", "smallbank", "golden_nowait_smallbank.json"),
    ("mvcc", "ycsb", "golden_mvcc_ycsb.json"),
)
SWEEP_PATH = "nowait/smallbank/sweep64"  # NOWAIT/SmallBank's 64 hybrid codes as one bucket
CALVIN_PATH = "calvin"  # smallbank, ycsb and tpcc x CODES, one bucket each: no RCC kernel on its path
# kernel launches per batched tick on each path's kernel plane, whatever its config count: one
# lock_arbiter per try_lock (one block per config), one multi_read per gather_many (GATHERS) and one
# mvcc_version_select per fused version read (PICKS)
PER_TICK = {
    "nowait": {"lock_arbiter": 1, "multi_read": 2, "mvcc_version_select": 0, "flash_attention": 0},
    "mvcc": {"lock_arbiter": 1, "multi_read": 5, "mvcc_version_select": 3, "flash_attention": 0},
}
R_RECORDS = 4 * 65536  # the RCC main paths' store rows per config
# the shapes each RCC path hands the kernels: (G configs, N slots per config, K ops per txn); the store
# arrays are (G*R_RECORDS, ...) and the keys store rows g*R_RECORDS + key
ONE_PATH = "nowait/smallbank/g1"  # hybrid 63 alone: configs per second at G = 1
SHAPES = {"nowait/smallbank": (4, 240, 2), "mvcc/ycsb": (4, 240, 10), SWEEP_PATH: (64, 240, 2), ONE_PATH: (1, 240, 2)}
# each path's gather_many calls per batched tick on the kernel plane: {what: (the arrays' shapes after the
# rows, calls per tick)}.  MVCC: the read effect's rts_hi; the rts pair of the read and lock effects' Cond W1
# checks and try_lock's lock pair; the commit's wts_hi|wts_lo|ver
_NOWAIT_GATHERS = {"lock_hi|lock_lo": (((), ()), 1), "data|ver (rw 2)": (((2,), ()), 1)}
GATHERS = {
    "nowait/smallbank": _NOWAIT_GATHERS,
    "mvcc/ycsb": {"rts_hi": (((),), 1), "rts or lock pair": (((), ()), 3), "wts_hi|wts_lo|ver": (((4,), (4,), ()), 1)},
    SWEEP_PATH: _NOWAIT_GATHERS,
    ONE_PATH: _NOWAIT_GATHERS,
}
# the MVCC path's fused version reads per batched tick: (S, {with the lock: reads per tick}): the read and
# rts effects check the lock, the lock effect does not
PICKS = {"mvcc/ycsb": (4, {True: 2, False: 1})}
# the node layout: four node shards of one config on the one card (a device may repeat), each owning one
# simulated node's 65536 rows.  Per tick the coordinator runs one lock_arbiter per try_lock over the global rows
# (the contest reads no store word), and each shard one multi_read per gather_many on its own rows; MVCC's
# version reads take the reference's route there (the wts and lock rows in one exchange each, then
# mvcc_version_select on the combined rows, once per read)
NODE_SHARDS = 4
NODE_DEVICES = ("cuda",) * NODE_SHARDS
R_LOCAL = R_RECORDS // NODE_SHARDS
NODE_PER_TICK = {
    "nowait": {"lock_arbiter": 1, "multi_read": 8, "mvcc_version_select": 0, "flash_attention": 0},
    "mvcc": {"lock_arbiter": 1, "multi_read": 40, "mvcc_version_select": 3, "flash_attention": 0},
}
# the config_node path: two config shards, each one run of two configs on two node shards
CONFIG_NODE_PER_TICK = {"lock_arbiter": 2, "multi_read": 8, "mvcc_version_select": 0, "flash_attention": 0}
NODE_NOWAIT, NODE_MVCC, NODE_CALVIN = "nowait/smallbank/node4", "mvcc/ycsb/node4", "calvin/smallbank/node4"
CONFIG_NODE_PATH = "nowait/smallbank/config_node2x2"  # CODES on 2 config shards x 2 node shards
# each node path's per-shard calls per tick: {what: (the arrays' shapes after the rows, calls per shard)}
NODE_GATHERS = {
    NODE_NOWAIT: _NOWAIT_GATHERS,
    NODE_MVCC: {"rts_hi": (((),), 1), "rts or lock pair": (((), ()), 5), "wts pair": (((4,), (4,)), 3),
                "wts_hi|wts_lo|ver": (((4,), (4,), ()), 1)},
}
NODE_SHAPES = {NODE_NOWAIT: (1, 240, 2), NODE_MVCC: (1, 240, 10)}
# the legacy PRNG mode (jax_threefry_partitionable=False): tests/data/stage_graph_golden.json's 24 rows (9 runs at
# tests/test_sweep.py's grid), NOWAIT/SmallBank and MVCC/YCSB at the full spec (golden_legacy_prng.json) and four node
# shards of NOWAIT/SmallBank hybrid 63, all through the deprecated sweep entry points
LEGACY_STAGE_PATH = "legacy/stage_graph"
LEGACY_NODE_PATH = "legacy/nowait/smallbank/node4"
STAGE_KW = dict(n_nodes=2, coroutines=8, records_per_node=128, ticks=64, warmup=8)
STAGE_CELLS = tuple((p, "smallbank", CODES) for p in ("nowait", "waitdie", "occ", "mvcc", "sundial")) + tuple(
    (p, "ycsb", (21,)) for p in ("nowait", "occ", "sundial", "mvcc"))
# kernel launches per batched tick of the other stage-graph protocols, as PER_TICK's: one lock_arbiter per
# try_lock, one multi_read per gather_many
LEGACY_PER_TICK = dict(PER_TICK, **{p: {"lock_arbiter": 1, "multi_read": n, "mvcc_version_select": 0,
                                        "flash_attention": 0} for p, n in (("waitdie", 3), ("occ", 3), ("sundial", 8))})
# the tick profiles' windows: warm-up ticks, then this many ticks timed bare and as many traced (40 and 20 through
# PR 28; cut for the smoke's time limit when the examples phase came in)
PROFILE_WARMUP, PROFILE_TICKS = 10, 10
# H100 SXM peaks: the HBM3 rate (NVIDIA data sheet), and the INT32 issue rate
# that bounds integer compares and selects: 132 SMs x 64 INT32 lanes per SM x
# 1.98 GHz boost clock = 16.7e12 ops/s (the data sheet's 67 TFLOP/s float32
# counts an FMA as two flops on 128 FP32 lanes per SM; a Hopper SM has 64
# INT32 lanes)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 FMA outside the tensor cores (NVIDIA data sheet, H100 SXM): the flash_attention bound
FP32_FLOPS_PER_S = 67e12
# the LM serving main path: stablelm-1.6b at full width, float32
SERVE = dict(batch=4, prompt_len=2048, gen_len=32, page_size=16)
SERVE_PATH = "serve/stablelm-1.6b"
# the MoE serving main path: llama4-scout-17b-a16e at full width, depth cut to MOE_LAYERS of 48 (6.22 B float32
# parameters, 24.9 GB; 6 layers, 58.1 GB, fit the card: cut for the smoke's time limit, PERF.md section 4), the
# same requests as SERVE
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 2
MOE_SERVE_PATH = "serve/llama4-scout-17b-a16e"
# the same model and requests on a 1 x 4 mesh of shards on the one card (sharding.AxisRules over
# launch.mesh.make_host_mesh(1, 4, devices=("cuda",) * 4)): the expert-parallel MoE (16 experts, 4 a shard) and
# the sequence-sharded KV cache (S = prompt + generated tokens, 4 | S), through train.steps' builders
MESH_SERVE_PATH = "serve/llama4-scout-17b-a16e@1x4"
MESH_SHAPE = (1, 4)
# the SSM serving main path: falcon-mamba-7b at full width, depth cut to SSM_LAYERS of 64 (1.38 B float32
# parameters, 5.5 GB; all 64, 29.1 GB, fit the card: cut for the smoke's time limit, PERF.md section 4), the same
# requests as SERVE
SSM_ARCH = "falcon-mamba-7b"
SSM_LAYERS = 8
SSM_SERVE_PATH = "serve/falcon-mamba-7b"
SSM_STEPS = ("in_proj", "conv", "x_proj/dt", "scan", "out_proj")  # ssm.Record's profiler ranges
# the hybrid serving main path: recurrentgemma-2b at full width and all 26 layers (3.31 B float32 parameters,
# 13.3 GB), the same requests as SERVE: the prompt fills the 2048-token window, so decode wraps the ring
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_SERVE_PATH = "serve/recurrentgemma-2b"
HYBRID_STEPS = ("in/gate proj", "conv", "gates", "scan", "out_proj")  # rglru.Record's profiler ranges
HYBRID_PARAMS = 3_314_096_640
# the encoder-decoder serving main path: whisper-small at full width and depth (12 encoder and 12 decoder layers,
# 278,143,488 float32 parameters, 1.11 GB): 4 requests of one 30-second audio window (1500 frame embeddings), a
# 224-token prompt and 224 greedy tokens each, the 448 of Whisper's text context
WHISPER_ARCH = "whisper-small"
WHISPER_SERVE = dict(batch=4, prompt_len=224, gen_len=224, page_size=16)
WHISPER_SERVE_PATH = "serve/whisper-small"
WHISPER_PARAMS = 278_143_488
# the M-RoPE VLM serving main path: qwen2-vl-72b at full width, depth cut to VLM_LAYERS of 80 (4,246,794,240
# float32 parameters, 17.0 GB; 12 fit the card: cut for the smoke's time limit, PERF.md section 4), the same
# requests as SERVE (text-only positions, as the reference's serve passes them)
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 2
VLM_SERVE_PATH = "serve/qwen2-vl-72b"
# the last three dense serving main paths, at full width, each cut for the smoke's time limit to the depth of its
# golden file (2 layers of the config's: nemotron-4-15b 2 of 32, 3.93 B parameters; qwen2.5-32b 2 of 64, 2.53 B;
# command-r-35b 2 of 40, 3.51 B; 16, 8 and 6 fit the card, PERF.md section 4), the same requests as SERVE, and each
# one's golden file
DENSE_LAYERS = {"nemotron-4-15b": 2, "qwen2.5-32b": 2, "command-r-35b": 2}
DENSE_GOLDEN = {"nemotron-4-15b": "golden_serve_nemotron.json", "qwen2.5-32b": "golden_serve_qwen2_5.json",
                "command-r-35b": "golden_serve_command_r.json"}
# kimi-k2-1t-a32b at full width, the depth cut to 1 of 61 layers (19.38 B float32 parameters, 77.5 GB: a second layer
# does not fit the card), one request of 2048 tokens, 32 each (4 requests would add about 10 GB of MoE buffers)
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1
KIMI_SERVE = dict(batch=1, prompt_len=2048, gen_len=32, page_size=16)
KIMI_SERVE_PATH = "serve/kimi-k2-1t-a32b"
# logits tolerance of the serving phase (absolute; logits have std 0.88).  The port
# on the CPU is within 7.9e-6 of the JAX reference at full width (the golden file's
# port_cpu_max_abs_logit_gap); 1e-4 leaves 12x that for the card's other summation
# order (cuBLAS float32 products, the kernel's online softmax).  Greedy tokens must
# agree wherever the top-1/top-2 margin exceeds 10x this.
LOGIT_TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, *, reps=200, warm=10):
    """Milliseconds per call as the host issues them back to back: CUDA
    events around ``reps`` eager calls (launch and host overheads included)."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, *, reps=100):
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host work is timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, ops_per_s=INT32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the card's peak rate for their type (integer
    operations by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


I32_WORDS = (-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1)


def arbiter_case(G, M, n_keys, gen, *, ties=False, pad=False, extremes=False, rows=0):
    """A random arbitration batch (narrow hi, so lo often decides; 70 %
    active); ``ties`` makes pairs share (hi, lo), ``pad`` adds a tail of
    inactive -1 keys, ``extremes`` draws keys, hi and lo from the int32
    extremes; n_keys = 1 puts every request on one key.  ``rows`` > 0 offsets
    group g's keys by g*rows (store rows, as a batched run hands them over);
    with rows = 0 every group draws from the same keys."""
    import torch

    keys = torch.randint(0, max(n_keys, 1), (G, M), generator=gen, dtype=torch.int32)
    hi = torch.randint(-3, 4, (G, M), generator=gen, dtype=torch.int32)  # narrow: lo decides
    lo = torch.stack([torch.randperm(M, generator=gen) for _ in range(G)]).to(torch.int32) if M else \
        torch.zeros((G, 0), dtype=torch.int32)
    if ties:
        lo = lo // 2  # pairs share (hi, lo): several winners per key
    if extremes:
        words = torch.tensor(I32_WORDS, dtype=torch.int32)
        keys, hi, lo = (words[torch.randint(0, len(I32_WORDS), (G, M), generator=gen)] for _ in range(3))
    if rows:
        keys = keys + torch.arange(G, dtype=torch.int32)[:, None] * rows
    act = torch.rand((G, M), generator=gen) < 0.7
    if pad and M:
        keys[:, -max(1, M // 4):] = -1
        act[:, -max(1, M // 4):] = False
    return [t.cuda() for t in (keys, hi, lo, act)]


def arbiter_ref(args):
    """lock_arbiter's plain version, a group at a time where its (G, M, M)
    pair tensor would pass 64 MB a call."""
    import torch

    from repro_torch.kernels.ref import lock_arbiter_ref

    G, M = args[0].shape
    if G * M * M <= 2**26:
        return lock_arbiter_ref(*args)
    return torch.cat([lock_arbiter_ref(*(a[g:g + 1] for a in args)) for g in range(G)])


def timed(fn, plain, library=None):
    """Device ms per call (graph-replayed) and ms per call issued eagerly,
    for a kernel, its plain version and, where there is one, a library call."""
    t = {"ms": time_graph_ms(fn), "plain_ms": time_graph_ms(plain),
         "host_ms": time_ms(fn), "plain_host_ms": time_ms(plain)}
    t["library_ms"] = time_graph_ms(library) if library else None
    t["library_host_ms"] = time_ms(library) if library else None
    return t


def mix(parts):
    """The launch-weighted mean of timing rows: [(weight, row), ...]; a
    key that some row lacks (None) stays None; bound_by is that of the
    largest weighted bound."""
    total = sum(w for w, _ in parts)
    out = {}
    for k, v in parts[0][1].items():
        if isinstance(v, (int, float)) and all(r.get(k) is not None for _, r in parts):
            out[k] = sum(w * r[k] for w, r in parts) / total
        elif k != "bound_by":
            out[k] = v if len(parts) == 1 else None
    out["bound_by"] = max(parts, key=lambda p: p[0] * p[1]["bound_ms"])[1]["bound_by"]
    return out


def phase_kernels():
    """Each kernel against its plain version on the card, exactly, at every
    main path's batched shapes and at edge cases, then timed at each main
    path's shapes.  Returns the kernels' measurement rows (without
    ``launches``), each with ``by_path``: its numbers at each main path's
    shapes."""
    import torch

    from repro_torch.kernels.lock_arbiter import lock_arbiter

    gen = torch.Generator().manual_seed(0)
    rows, t0 = [], time.perf_counter()

    # lock_arbiter: the main paths' (G, M = N*K) over G*262144 store rows, then edge cases
    worst = 0
    cases = [dict(G=G, M=N * K, n_keys=R_RECORDS, rows=R_RECORDS) for G, N, K in SHAPES.values()]
    cases += [
        dict(G=64, M=2400, n_keys=R_RECORDS, rows=R_RECORDS), dict(G=4, M=480, n_keys=64, ties=True, rows=R_RECORDS),
        # every group on the same keys: a group's table must never see another group's requests
        dict(G=64, M=480, n_keys=64, ties=True), dict(G=4, M=2400, n_keys=600, ties=True),
        dict(G=64, M=2400, n_keys=300, pad=True),
        dict(G=1, M=480, n_keys=R_RECORDS), dict(G=1, M=480, n_keys=64), dict(G=1, M=480, n_keys=64, ties=True),
        dict(G=1, M=2400, n_keys=R_RECORDS), dict(G=1, M=2400, n_keys=R_RECORDS, ties=True),
        dict(G=1, M=2400, n_keys=R_RECORDS, pad=True), dict(G=1, M=2400, n_keys=600, ties=True),
        dict(G=3, M=37, n_keys=9, pad=True), dict(G=3, M=1, n_keys=1), dict(G=1, M=0, n_keys=1),
        dict(G=1, M=2048, n_keys=300, ties=True), dict(G=2, M=2048, n_keys=40, pad=True),
        # one hot key, with and without exact ties; int32 extremes; the global-memory table (M > 4096)
        dict(G=1, M=2400, n_keys=1), dict(G=1, M=2400, n_keys=1, ties=True),
        dict(G=1, M=2400, n_keys=0, extremes=True), dict(G=2, M=480, n_keys=0, extremes=True, pad=True),
        dict(G=2, M=12000, n_keys=R_RECORDS), dict(G=2, M=12000, n_keys=50, ties=True, pad=True),
    ]
    for c in cases:
        args = arbiter_case(c["G"], c["M"], c["n_keys"], gen, ties=c.get("ties", False), pad=c.get("pad", False),
                            extremes=c.get("extremes", False), rows=c.get("rows", 0))
        got = lock_arbiter(*args)
        want = arbiter_ref(args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        worst = max(worst, bad)
        log(f"  lock_arbiter {c}: {bad} mismatches, {int(want.sum())} winners")
        if bad:
            raise AssertionError(f"lock_arbiter disagrees with its plain version at {c}")
    by_path = {}
    for path, G, M in [(p, G, N * K) for p, (G, N, K) in SHAPES.items()] + [("not a main path", 64, 2400)]:
        args = arbiter_case(G, M, R_RECORDS, gen, rows=R_RECORDS)
        t = timed(lambda: lock_arbiter(*args), lambda: arbiter_ref(args))
        # the function's least work: one pass over 3 int32 + 1 bool in and 1 bool out per request
        t["bound_ms"], t["bound_by"] = bound_ms(G * M * 14, 0)
        log(f"lock_arbiter ({path}: G={G}, M={M}): {t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued "
            f"eagerly), plain {t['plain_ms']:.6f} ms ({t['plain_host_ms']:.6f}), "
            f"bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
        if path in SHAPES:
            by_path[path] = dict(t, G=G, M=M)
    rows.append(dict(
        name="lock_arbiter", route="cuda", source="src/repro_torch/kernels/csrc/lock_arbiter.cu",
        replaces="src/repro/kernels/lock_arbiter.py:41", max_abs_err=float(worst), by_path=by_path,
    ))

    for phase in (phase_multi_read, phase_version_select, phase_flash):
        log(f"kernel phase: {rows[-1]['name']} checked and timed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rows.append(phase(gen))
    log(f"kernel phase: {rows[-1]['name']} checked and timed in {time.perf_counter() - t0:.1f} s")
    return rows


def version_case(M, S, gen, kind="random"):
    """A version-select batch: narrow words (ties, empty slots, ctts equal
    to a wts all occur), or one edge case."""
    import torch

    def ints(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    wh, wl, ch, cl, lh, ll = ints(M, S), ints(M, S), ints(M), ints(M), ints(M, lo=-1, hi=2), ints(M, lo=-1, hi=2)
    if kind == "empty":
        wh.zero_()
        wl.zero_()
    elif kind == "ctts_eq" and M:
        pick = torch.randint(0, S, (M,), generator=gen)
        ch, cl = wh[torch.arange(M), pick].clone(), wl[torch.arange(M), pick].clone()
    elif kind == "ties":  # slots 1 .. S//2 tie on the winning pair: the first (slot 1) must win
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        wh[:, 0] = 0
        ch.fill_(1)
        cl.fill_(2)
    elif kind == "lock_eq":
        lh, ll = ch.clone(), cl.clone()
    elif kind == "extremes":
        words = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], dtype=torch.int32)
        wh, wl = (words[torch.randint(0, 7, (M, S), generator=gen)] for _ in range(2))
        ch, cl, lh, ll = (words[torch.randint(0, 7, (M,), generator=gen)] for _ in range(4))
    elif kind == "engine":  # the main path's inputs: (hi, lo) = (clock, slot id + 1), slot 0 seeded (0, 1)
        wh = torch.randint(0, 400, (M, S), generator=gen, dtype=torch.int32)
        wl = torch.randint(1, 241, (M, S), generator=gen, dtype=torch.int32)
        wh[:, 0], wl[:, 0] = 0, 1
        ch = torch.randint(0, 400, (M,), generator=gen, dtype=torch.int32)
        cl = torch.randint(1, 241, (M,), generator=gen, dtype=torch.int32)
        free = torch.rand((M,), generator=gen) < 0.8
        lh = torch.where(free, 0, torch.randint(0, 400, (M,), generator=gen, dtype=torch.int32))
        ll = torch.where(free, 0, torch.randint(1, 241, (M,), generator=gen, dtype=torch.int32))
    return [t.cuda() for t in (wh, wl, ch, cl, lh, ll)]


def read_case(R, N, K, S, gen, kind="narrow"):
    """A fused version read's inputs on the card: the store's wts (R, S) and
    lock (R,) words, keys (N, K) in [-3, R+3) and one ctts pair per row of
    keys.  ``narrow`` words (empty slots, ties, ctts == wts, lock == ctts
    all occur), ``engine`` the main path's (hi, lo) = (clock, slot id + 1)
    words, ``extremes`` int32 extremes, ``ties`` slots 1 .. S//2 tied on
    the winning pair, ``empty`` every slot (0, 0); ``unaligned`` narrow
    words in views 4 bytes past a 16-byte boundary (the scalar path)."""
    import torch

    def ints(*shape, lo=-1, hi=3):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    wh, wl, lh, ll, ch, cl = ints(R, S), ints(R, S), ints(R), ints(R), ints(N), ints(N)
    if kind == "engine":
        wh, wl = ints(R, S, lo=0, hi=400), ints(R, S, lo=1, hi=241)
        wh[:, 0], wl[:, 0] = 0, 1
        ch, cl = ints(N, lo=0, hi=400), ints(N, lo=1, hi=241)
        free = torch.rand((R,), generator=gen) < 0.8
        lh, ll = torch.where(free, 0, ints(R, lo=0, hi=400)), torch.where(free, 0, ints(R, lo=1, hi=241))
    elif kind == "extremes":
        words = torch.tensor(I32_WORDS, dtype=torch.int32)
        wh, wl = (words[torch.randint(0, 7, (R, S), generator=gen)] for _ in range(2))
        lh, ll = (words[torch.randint(0, 7, (R,), generator=gen)] for _ in range(2))
        ch, cl = (words[torch.randint(0, 7, (N,), generator=gen)] for _ in range(2))
    elif kind == "ties":
        wh[:, : S // 2 + 1], wl[:, : S // 2 + 1] = 1, 1
        wh[:, 0] = 0
        ch.fill_(1)
        cl.fill_(2)
    elif kind == "empty":
        wh.zero_()
        wl.zero_()
    keys = torch.randint(-3, R + 3, (N, K), generator=gen, dtype=torch.int32).cuda()
    wh, wl, lh, ll, ch, cl = (t.cuda() for t in (wh, wl, lh, ll, ch, cl))
    if kind == "unaligned":
        wh, wl, lh, ll = (unaligned(t) for t in (wh, wl, lh, ll))
    return wh, wl, lh, ll, keys, ch, cl


def unaligned(t):
    """``t``'s values in storage that starts 4 bytes past a 16-byte
    boundary: a contiguous view that the 16-byte paths must refuse."""
    import torch

    flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


def packed_gather(arrs, keys):
    """The parent tree's ``ops.gather_many`` on the kernel plane, op for op,
    with this tree's kernel: the whole store arrays concatenated into one
    packed (R, A) table, one one-array gather, column views shaped like
    the keys."""
    import torch

    from repro_torch.kernels.multi_read import multi_read

    R = arrs[0].shape[0]
    cols = [a.reshape(R, -1) for a in arrs]
    table = cols[0].contiguous() if len(cols) == 1 else torch.cat(cols, dim=1)
    out = multi_read(table, keys.reshape(-1).contiguous())
    outs, pos = [], 0
    for a, c in zip(arrs, cols):
        outs.append(out[:, pos:pos + c.shape[1]].reshape(tuple(keys.shape) + tuple(a.shape[1:])))
        pos += c.shape[1]
    return tuple(outs)


def parent_pick(wh, wl, keys, ch, cl, lh=None, ll=None):
    """The parent tree's kernel-plane version pick, op for op, with this
    tree's kernels: the wts pair and the lock pair gathered through packed
    tables (``packed_gather``), a zero lock filled in when there is none,
    ctts expanded to one pair per op, every input copied contiguous, then
    the pick over per-op rows."""
    import torch

    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    shp, S = tuple(keys.shape), wh.shape[1]
    vh, vl = packed_gather((wh, wl), keys)
    z = torch.zeros(shp, dtype=torch.int32, device=keys.device)
    gh, gl = packed_gather((lh, ll), keys) if lh is not None else (z, z)

    def flat(a):
        return a.expand(shp).reshape(-1)

    args = (vh.reshape(-1, S), vl.reshape(-1, S), flat(ch[:, None]), flat(cl[:, None]), flat(gh), flat(gl))
    return mvcc_version_select(*(a.contiguous() for a in args))


def one_device_op(fn, kernel, case):
    """One call of ``fn`` must put exactly one operation on the device, a
    launch of ``kernel`` (no copy, no fill, no cat).

    The call is captured in a CUDA graph and the graph's nodes are read
    from its DOT dump (``cudaGraphDebugDotPrint``): the capture holds every
    operation the call enqueues, and needs no profiler, whose short traces
    of one small kernel held no device event now and then.  The wrapper
    must count the one launch, as it counts a launch on the main path."""
    import importlib
    import re
    import tempfile
    import warnings

    import torch

    wrapper = getattr(importlib.import_module(f"repro_torch.kernels.{kernel}"), kernel)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: builds and loads the kernel
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept uninstantiated, for debug_dump
    before = wrapper.launches
    with torch.cuda.graph(graph):
        fn()
    counted = wrapper.launches - before
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it dumps
        graph.debug_dump(os.path.join(d, "call.dot"))
        with open(os.path.join(d, "call.dot")) as f:
            dot = f.read()
    del graph
    nodes = sorted(set(re.findall(r"graph_\d+_node_\d+", dot)))
    kinds = sorted(set(re.findall(r"\b(KERNEL|MEMCPY|MEMSET|HOST|EMPTY|EVENT_RECORD|WAIT_EVENT|MEM_ALLOC|MEM_FREE"
                                  r"|CONDITIONAL|CHILD_GRAPH)\b", dot)))
    if len(nodes) != 1 or kinds != ["KERNEL"] or kernel + "_kernel" not in dot or counted != 1:
        raise AssertionError(f"{case}: one call must be one {kernel} launch; its graph holds {len(nodes)} nodes of "
                             f"kinds {kinds}, {kernel}_kernel {'in' if kernel + '_kernel' in dot else 'not in'} it, "
                             f"the wrapper counted {counted}:\n{dot}")


def phase_multi_read(gen):
    """multi_read against its plain version on the card, exactly: 1 to 4
    arrays of widths 1 to 16 read in place, keys in [-3, R+3), M = 0, 480,
    2400 and 12000, views that are not 16-byte aligned, and the one-array
    packed-table call.  Then, at each main path's gather_many calls, the
    whole ops-level call on the kernel plane (one launch, checked with the
    profiler) against the torch plane's per-array ``a[keys]`` (the library
    call), the plain version and the parent's packed sequence."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.multi_read import multi_read, multi_read_many
    from repro_torch.kernels.ref import gather_many_ref, multi_read_ref

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int32).cuda()

    worst = 0

    def check(got, want, label):
        nonlocal worst
        torch.cuda.synchronize()
        if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
            raise AssertionError(f"multi_read {label}: shapes {[g.shape for g in got]} != {[w.shape for w in want]}")
        err = max((int((g.long() - w.long()).abs().max()) for g, w in zip(got, want) if w.numel()), default=0)
        worst = max(worst, err)
        if err or not all(g.is_contiguous() for g in got):
            raise AssertionError(f"multi_read disagrees with its plain version at {label}: max |err| {err}")

    width_sets = [(1,), (2,), (3,), (4,), (8,), (9,), (16,), (4, 4), (2, 1), (16, 1), (1, 1, 1), (4, 4, 1),
                  (3, 9, 8, 1), (16, 4, 2, 1)]
    for M in (0, 480, 2400, 12000):
        R = R_RECORDS if M in (480, 2400) else 1000
        for ws in width_sets:
            arrs = [rand(R, w) if w > 1 else rand(R) for w in ws]
            keys = torch.randint(-3, R + 3, (M,), generator=gen, dtype=torch.int32).cuda()
            check(multi_read_many(arrs, keys), gather_many_ref(arrs, keys), f"R={R} M={M} widths {ws}")
            if ws in ((4,), (16, 1), (3, 9, 8, 1)) and M:
                views = [unaligned(a) for a in arrs]
                check(multi_read_many(views, keys), gather_many_ref(arrs, keys), f"unaligned R={R} M={M} widths {ws}")
        for A in (1, 2, 3, 8, 9):
            table, keys = rand(R, A), torch.randint(-3, R + 3, (M,), generator=gen, dtype=torch.int32).cuda()
            check((multi_read(table, keys),), (multi_read_ref(table, keys),), f"one table R={R} M={M} A={A}")
        log(f"  multi_read M={M} (R={R}, keys in [-3, R+3)): {len(width_sets)} array sets, 5 one-table widths, "
            f"the unaligned views: max |err| 0")

    by_path = {}
    for path, sets in GATHERS.items():
        G, N, K = SHAPES[path]
        M, R, parts = G * N * K, G * R_RECORDS, []
        # store rows: config g's keys lie in [g*R_RECORDS, (g+1)*R_RECORDS), the first and last of each included
        keys = torch.randint(0, R_RECORDS, (G, N, K), generator=gen, dtype=torch.int32)
        keys[:, 0, 0], keys[:, 0, 1] = 0, R_RECORDS - 1
        keys = (keys + torch.arange(G, dtype=torch.int32)[:, None, None] * R_RECORDS).reshape(G * N, K).cuda()
        kf = keys.reshape(-1)
        for name, (shapes, n) in sets.items():
            arrs = [torch.randint(0, 1000, (R,) + s, generator=gen, dtype=torch.int32).cuda() for s in shapes]
            fn = lambda: ops.gather_many(arrs, keys, plane=ops.KERNEL)  # noqa: E731
            one_device_op(fn, "multi_read", f"gather_many {path} {name}")
            for g, w, p in zip(fn(), packed_gather(arrs, keys), gather_many_ref(arrs, kf)):
                if not torch.equal(g, w) or not torch.equal(g.reshape(p.shape), p):
                    raise AssertionError(f"multi_read ({path}, {name}): the plain version or the parent's packed "
                                         "sequence disagrees")
            t = timed(fn, lambda: gather_many_ref(arrs, kf), lambda: ops.gather_many(arrs, keys, plane=ops.TORCH))
            packed = lambda: packed_gather(arrs, keys)  # noqa: E731
            t["packed_ms"], t["packed_host_ms"] = time_graph_ms(packed), time_ms(packed)
            words = sum(math.prod(s) for s in shapes)
            t["bound_ms"], t["bound_by"] = bound_ms(M * 4 + 2 * M * words * 4, 0)  # keys + rows read + rows written
            log(f"multi_read ({path}: {name}, G={G}, R={R}, M={M}, {n} per tick): ops.gather_many "
                f"{t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued eagerly), the parent's packed "
                f"sequence {t['packed_ms']:.6f} ({t['packed_host_ms']:.6f}), per-array a[keys] "
                f"{t['library_ms']:.6f} ({t['library_host_ms']:.6f}), plain {t['plain_ms']:.6f} "
                f"({t['plain_host_ms']:.6f}), bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_path[path] = dict(mix(parts), G=G, M=M, calls_per_tick={name: n for name, (_, n) in sets.items()})
    return dict(
        name="multi_read", route="cuda", source="src/repro_torch/kernels/csrc/multi_read.cu",
        replaces="src/repro/kernels/multi_read.py:41", max_abs_err=float(worst), by_path=by_path,
    )


def phase_version_select(gen):
    """mvcc_version_select against its plain versions, exactly: the fused
    read (store rows at keys in [-3, R+3), with and without the lock, S =
    1, 2, 4, 16, M = 0 to 12000, ties, empty slots, int32 extremes,
    unaligned views), picks over row views with one ctts pair per
    transaction, and per-op picks at edge cases.  Then, at the main path's
    picks, the fused read (one launch, checked with the profiler) against
    the plain version and the parent's sequence for the same pick."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.mvcc_version_select import mvcc_version_read, mvcc_version_select
    from repro_torch.kernels.ref import mvcc_version_select_ref, version_read_ref

    worst = 0

    def check(got, want, label):
        nonlocal worst
        torch.cuda.synchronize()
        bad = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (w is not None and (g.dtype != w.dtype or g.shape != w.shape)):
                raise AssertionError(f"mvcc_version_select {label}: outputs differ in kind, dtype or shape")
            if w is not None and w.numel():
                bad += int((g != w).sum())
                worst = max(worst, int((g.long() - w.long()).abs().max()))
        if bad:
            raise AssertionError(f"mvcc_version_select disagrees with its plain version at {label}: {bad} mismatches")

    reads = [(R_RECORDS, 240, 10, 4, kind) for kind in ("engine", "narrow", "ties", "empty", "extremes", "unaligned")]
    reads += [(1000, N, K, S, "narrow") for N, K in ((0, 10), (48, 10), (240, 10), (1200, 10)) for S in (1, 2, 4, 16)]
    reads += [(50, 37, 3, S, kind) for S in (1, 4, 16) for kind in ("ties", "empty", "extremes", "unaligned")]
    for R, N, K, S, kind in reads:
        wh, wl, lh, ll, keys, ch, cl = read_case(R, N, K, S, gen, kind)
        for lock in ((lh, ll), (None, None)):
            got = mvcc_version_read(wh, wl, keys, ch, cl, *lock)
            check(got, version_read_ref(wh, wl, keys, ch, cl, *lock), f"read R={R} N={N} K={K} S={S} {kind}")
            inside = (keys >= 0) & (keys < R)  # a key outside reads empty slots: slot 0
            if kind == "ties" and S > 1 and not bool((got[1][inside] == 1).all()):
                raise AssertionError("mvcc_version_select: the first of tied winning slots must win")
    log(f"  mvcc_version_select: {2 * len(reads)} fused reads (keys in [-3, R+3), with and without the lock) "
        f"equal their plain version")
    for S in (1, 4, 16):  # row views: column slices of one (M, 2S) table, one ctts pair per 10 ops
        table = torch.randint(-1, 3, (2400, 2 * S), generator=gen, dtype=torch.int32).cuda()
        ch, cl = (torch.randint(-1, 3, (240,), generator=gen, dtype=torch.int32).cuda() for _ in range(2))
        lh, ll = (torch.randint(-1, 2, (2400,), generator=gen, dtype=torch.int32).cuda() for _ in range(2))
        got = mvcc_version_select(table[:, :S], table[:, S:], ch, cl, lh, ll)
        want = mvcc_version_select_ref(table[:, :S], table[:, S:], ch.repeat_interleave(10), cl.repeat_interleave(10),
                                       lh, ll)
        check(got, want, f"row views S={S}")
    cases = [(2400, 4, "engine"), (2400, 4, "random")]
    cases += [(2400, S, "random") for S in (1, 2, 3, 8, 16)]
    cases += [(M, 4, "random") for M in (0, 1, 37)]
    cases += [(37, S, kind) for S in (1, 4, 16) for kind in ("empty", "ctts_eq", "ties", "lock_eq", "extremes")]
    for M, S, kind in cases:
        args = version_case(M, S, gen, kind)
        check(mvcc_version_select(*args), mvcc_version_select_ref(*args), f"per-op M={M} S={S} {kind}")
    log(f"  mvcc_version_select: row views at S = 1, 4, 16 and {len(cases)} per-op cases equal their plain version")

    by_path = {}
    for path, (S, picks) in PICKS.items():
        G, N1, K = SHAPES[path]
        N, R = G * N1, G * R_RECORDS
        M, parts = N * K, []
        wh, wl, lh, ll, keys, ch, cl = read_case(R, N, K, S, gen, "engine")
        keys = (torch.randint(0, R_RECORDS, (G, N1, K), generator=gen, dtype=torch.int32)
                + torch.arange(G, dtype=torch.int32)[:, None, None] * R_RECORDS).reshape(N, K).cuda()
        for with_lock, n in picks.items():
            lock = (lh, ll) if with_lock else (None, None)
            fn = lambda: ops.version_read(wh, wl, keys, ch, cl, *lock)  # noqa: E731
            one_device_op(fn, "mvcc_version_select", f"version_read {path} lock={with_lock}")
            parent = lambda: parent_pick(wh, wl, keys, ch, cl, *lock)  # noqa: E731
            got, old, plain = fn(), parent(), version_read_ref(wh, wl, keys, ch, cl, *lock)
            if not all(torch.equal(a.reshape(-1), b) for a, b in zip(got[:3 if with_lock else 2], old)) or \
                    not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"mvcc_version_select ({path}): the plain version or the parent's sequence "
                                     "disagrees")
            t = timed(fn, lambda: version_read_ref(wh, wl, keys, ch, cl, *lock))
            t["parent_seq_ms"], t["parent_seq_host_ms"] = time_graph_ms(parent), time_ms(parent)
            # bytes: keys, the ctts pairs, each op's 2S wts words (and lock pair) read; found, slot (and ok) and the
            # 2S gathered words written.  Operations: about 12 integer operations per slot and 6 for Cond R2
            n_in = M * 4 + N * 8 + M * 2 * S * 4 + (M * 8 if with_lock else 0)
            n_out = M * (1 + 4 + (1 if with_lock else 0)) + M * 2 * S * 4
            t["bound_ms"], t["bound_by"] = bound_ms(n_in + n_out, M * (12 * S + 6))
            log(f"mvcc_version_select ({path}: fused read, G={G}, R={R}, N={N}, K={K}, S={S}, "
                f"{'with' if with_lock else 'without'} the lock, {n} per tick): {t['ms']:.6f} ms/call on the device "
                f"({t['host_ms']:.6f} issued eagerly), the parent's sequence {t['parent_seq_ms']:.6f} "
                f"({t['parent_seq_host_ms']:.6f}), plain {t['plain_ms']:.6f} ({t['plain_host_ms']:.6f}), "
                f"no library call, bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_path[path] = dict(mix(parts), G=G, M=M, S=S,
                             picks_per_tick={"with lock": picks[True], "without": picks[False]})
    return dict(
        name="mvcc_version_select", route="cuda", source="src/repro_torch/kernels/csrc/mvcc_version_select.cu",
        replaces="src/repro/kernels/mvcc_version_select.py:47", max_abs_err=float(worst), by_path=by_path,
    )


def attn_inputs(B, H, Sq, Sk, Dh, dtype, gen, *, bshd=False):
    """q (B, H, Sq, Dh), k/v (B, H, Sk, Dh) on the card; with ``bshd`` they
    are (B, S, H, Dh) storage seen through a transpose, as the LM's
    ``attention_op`` hands them over; with ``bshd="unaligned"`` that storage
    is the last Dh of (B, S, H, Dh + 1) rows, so neither the base nor a row
    is 16-byte aligned (the kernel's plain-load path)."""
    import torch

    def one(S):
        if bshd == "unaligned":
            t = torch.randn((B, S, H, Dh + 1), generator=gen).to(dtype).cuda()
            return t[..., 1:].transpose(1, 2)
        t = torch.randn((B, S, H, Dh) if bshd else (B, H, S, Dh), generator=gen).to(dtype).cuda()
        return t.transpose(1, 2) if bshd else t

    return one(Sq), one(Sk), one(Sk)


def attn_work(B, H, Sq, Sk, Dh, causal, elem):
    """(bytes, flops) the attention must move and do: q, k, v read once and o
    written once; two products of 2*Dh flops per unmasked (row, key) pair."""
    pairs = sum(min(r + 1, Sk) for r in range(Sq)) if causal else Sq * Sk
    return elem * B * H * Dh * (2 * Sq + 2 * Sk), 4 * B * H * Dh * pairs


def flash_timing(gen, label, B, H, S, Dh, causal=True):
    """flash_attention at a prefill's call, as attention_op makes it (inputs
    from ``gen``), beside its plain version and SDPA, and its float32 bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = attn_inputs(B, H, S, S, Dh, torch.float32, gen, bshd=True)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    fn = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, causal=causal)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal)  # noqa: E731
    t = {"ms": time_graph_ms(fn, reps=10), "plain_ms": time_graph_ms(plain, reps=3),
         "library_ms": time_graph_ms(sdpa, reps=10), "host_ms": time_ms(fn, reps=10, warm=2),
         "plain_host_ms": time_ms(plain, reps=3, warm=1), "library_host_ms": time_ms(sdpa, reps=10, warm=2)}
    sdpa_err = float((sdpa().float() - plain().float()).abs().max())
    n_bytes, n_flops = attn_work(B, H, S, S, Dh, causal, 4)
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops, FP32_FLOPS_PER_S)
    mask = "causal" if causal else "not causal"
    log(f"flash_attention ({label}: B={B}, H={H}, S={S}, Dh={Dh}, {mask}, float32): {t['ms']:.6f} ms/call "
        f"on the device ({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ms "
        f"({t['plain_host_ms']:.6f}), SDPA {t['library_ms']:.6f} ms ({t['library_host_ms']:.6f}; max |err| vs "
        f"plain {sdpa_err:.3e}), bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {n_flops / 1e9:.2f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB), {n_flops / t['ms'] / 1e9:.2f} TFLOP/s")
    return dict(t, B=B, H=H, S=S, Dh=Dh, causal=causal)


def phase_flash(gen):
    """flash_attention against its plain version on the card, in the
    working dtype (1e-5 in float32, 3e-2 in bfloat16, the reference's
    tolerances: |err| <= tol + tol*|want|), then timed at the serving shape
    with the SDPA call as a yardstick."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    tols = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    dhs = (32, 64, 112, 128)
    cases = [(2, 3, S, S, Dh, causal, dt, False) for S in (1, 63, 64, 65, 128, 320) for Dh in dhs
             for causal in (True, False) for dt in tols]
    cases += [(1, 2, 2048, 2048, Dh, causal, dt, False) for Dh in dhs for causal in (True, False) for dt in tols]
    cases += [(2, 2, 50, 130, 64, False, dt, False) for dt in tols] + [(1, 2, 300, 77, 128, False, dt, False) for dt in tols]
    cases += [(1, 2, 130, 50, 32, True, torch.float32, False), (1, 2, 50, 130, 64, True, torch.float32, False)]
    cases += [(4, 32, 2048, 2048, 64, True, torch.float32, True), (2, 32, 256, 256, 64, True, torch.float32, True)]
    # the serving shape in bfloat16; Dh = 128 with Sq != Sk, causal; views whose rows are not 16-byte aligned
    cases += [(4, 32, 2048, 2048, 64, True, torch.bfloat16, True)]
    cases += [(2, 3, Sq, Sk, Dh, True, dt, True) for Sq, Sk in ((200, 333), (333, 200)) for Dh in (112, 128)
              for dt in tols]
    cases += [(2, 3, S, S, Dh, causal, dt, "unaligned") for S, Dh, causal in ((130, 64, True), (77, 32, False),
                                                                              (200, 128, True), (150, 112, True))
              for dt in tols]
    cases += [(1, 2, 70, 0, 64, causal, dt, False) for causal in (True, False) for dt in tols]  # Sk = 0: zeros
    # llama4-scout's prefill call (B = 4, Dh = 128, H = 40 after the GQA repeat) and kimi-k2's (B = 1, H = 64, Dh = 112)
    cases += [(4, 40, 2048, 2048, 128, True, torch.float32, True), (1, 64, 2048, 2048, 112, True, torch.float32, True)]
    # whisper-small's prefill calls: the encoder's over 1500 frames (not causal; 1500 is a multiple of neither the
    # 128-row q tile nor the 64-key tile) and the decoder's self-attention over the 224-token prompt
    cases += [(4, 12, 1500, 1500, 64, False, torch.float32, True), (4, 12, 224, 224, 64, True, torch.float32, True)]
    # qwen2-vl-72b's prefill call (B = 4, H = 64 after the GQA repeat, S = 2048, Dh = 128, causal; command-r-35b's
    # too) and nemotron-4-15b's (H = 48)
    cases += [(4, 64, 2048, 2048, 128, True, torch.float32, True), (4, 48, 2048, 2048, 128, True, torch.float32, True)]
    worst = {dt: 0.0 for dt in tols}
    for B, H, Sq, Sk, Dh, causal, dt, bshd in cases:
        q, k, v = attn_inputs(B, H, Sq, Sk, Dh, dt, gen, bshd=bshd)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        worst[dt] = max(worst[dt], float(err.max()))
        excess = float((err - tols[dt] * (1 + want.float().abs())).max())
        if excess > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention disagrees with its plain version at B={B} H={H} Sq={Sq} Sk={Sk} "
                                 f"Dh={Dh} causal={causal} {dt}: max |err| {float(err.max())}")
        del q, k, v, got, want, err
    log(f"  flash_attention: {len(cases)} cases within tolerance; max |err| float32 {worst[torch.float32]:.3e}, "
        f"bfloat16 {worst[torch.bfloat16]:.3e}")

    timing = functools.partial(flash_timing, gen)

    # whisper's prefill launches the kernel once per encoder layer and once per decoder layer: its path's row is the
    # two calls' launch-weighted mean, and each call's own row stands beside it
    cfg = get_config(WHISPER_ARCH)[0]
    B, H, T, P = WHISPER_SERVE["batch"], cfg.n_heads, cfg.enc_seq_len, WHISPER_SERVE["prompt_len"]
    whisper_calls = {"encoder": timing(f"{WHISPER_SERVE_PATH} encoder", B, H, T, cfg.head_dim, causal=False),
                     "decoder": timing(f"{WHISPER_SERVE_PATH} decoder", B, H, P, cfg.head_dim)}
    vlm = get_config(VLM_ARCH)[0]
    by_path = {SERVE_PATH: timing(SERVE_PATH, 4, 32, 2048, 64),  # the serving prefill's call
               MOE_SERVE_PATH: timing(MOE_SERVE_PATH, 4, 40, 2048, 128),
               VLM_SERVE_PATH: timing(VLM_SERVE_PATH, SERVE["batch"], vlm.n_heads, SERVE["prompt_len"], vlm.head_dim),
               WHISPER_SERVE_PATH: mix([(cfg.n_enc_layers, whisper_calls["encoder"]),
                                        (cfg.n_layers, whisper_calls["decoder"])])}
    # the dense paths' calls: a shape timed above is not timed again
    for arch in DENSE_LAYERS:
        c = get_config(arch)[0]
        same = next((r for r in by_path.values() if (r.get("H"), r.get("Dh")) == (c.n_heads, c.head_dim)), None)
        by_path[f"serve/{arch}"] = same or timing(f"serve/{arch}", SERVE["batch"], c.n_heads, SERVE["prompt_len"],
                                                  c.head_dim)
    kimi = get_config(KIMI_ARCH)[0]
    by_path[KIMI_SERVE_PATH] = timing(KIMI_SERVE_PATH, KIMI_SERVE["batch"], kimi.n_heads, KIMI_SERVE["prompt_len"],
                                      kimi.head_dim)
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:70", max_abs_err=worst[torch.float32],
        max_abs_err_bf16=worst[torch.bfloat16], by_path=by_path, whisper_calls=whisper_calls,
    )


def phase_profile(protocol, workload, codes=(63,), n_ticks=PROFILE_TICKS, devices=None):
    """Where one batched main-path tick's time goes: ``n_ticks`` ticks of
    one bucket of ``codes`` (kernel plane; node-sharded over ``devices``
    when given) timed bare, then traced with torch.profiler for the
    device's busy time, kernel launches and the host's top-level
    operations.  On YCSB with one config on one device, the workload's
    sequential key de-duplication is timed and traced alone as well, at
    the tick's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import init_run_store, init_state, node_mesh_config
    from repro_torch.core.registry import get_protocol, protocol_family
    from repro_torch.core.sweep import GridSpec, engine_config, make_knobs

    t_start = time.perf_counter()
    gs = GridSpec(protocol=protocol, workload=workload, kernel_plane="kernel", device="cuda")
    ec, cm, wl = engine_config(gs, make_knobs(workload, [{"hybrid": c} for c in codes]))
    if devices is not None:
        ec = node_mesh_config(ec, devices)
    tick = get_protocol(protocol).tick
    st = init_state(ec, wl)
    store = init_run_store(ec, protocol_family(protocol), wl.rw, wl.init_value)
    t = 0
    for _ in range(PROFILE_WARMUP):  # past warm-up allocations
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_ticks

    def device_events(fn, n):
        """The device events of ``n`` calls, and the host's top-level
        operations per call (torch operations and runtime calls with no
        parent)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        host = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.cpu_parent is None)
        return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA], host / n

    def one_tick():
        nonlocal st, store, t
        st, store = tick(ec, cm, wl, st, store, t)
        t += 1

    dev, host_ops = device_events(one_tick, n_ticks)
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_ticks
    by_family = {}  # kernel name up to its template/argument list -> [launches, us] per tick
    for e in dev:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        fam = by_family.setdefault(name.split("<")[0].split("(")[0].strip(), [0.0, 0.0])
        fam[0] += 1 / n_ticks
        fam[1] += e.time_range.elapsed_us() / n_ticks
    top = sorted(by_family.items(), key=lambda kv: -kv[1][1])[:8]
    names = ("lock_arbiter", "multi_read", "mvcc_version_select")
    cats = [e for e in dev if "CatArrayBatchedCopy" in e.name]
    prof_line = {
        "path": f"{protocol}/{workload}", "configs": len(codes), "node_shards": len(devices) if devices else 1,
        "tick_wall_ms": wall_ms, "device_busy_ms_per_tick": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
        "device_ops_per_tick": len(dev) / n_ticks, "host_top_level_ops_per_tick": host_ops,
        "top_device_launches_and_us_per_tick": dict(top),
        "cat_launches_and_us_per_tick": [len(cats) / n_ticks, sum(e.time_range.elapsed_us() for e in cats) / n_ticks],
        "kernel_launches_per_tick": {n: sum(1 for e in dev if n + "_kernel" in e.name) / n_ticks for n in names},
        "kernel_device_us": {
            n: sum(e.time_range.elapsed_us() for e in dev if n + "_kernel" in e.name)
            / max(1, sum(1 for e in dev if n + "_kernel" in e.name))
            for n in names
        },
    }
    if workload == "ycsb" and len(codes) == 1 and devices is None:
        from repro_torch.workloads.util import dedup_keys

        keys, slot = st["keys"].clone(), torch.arange(ec.n_slots, dtype=torch.int32, device="cuda")
        for _ in range(5):
            dedup_keys(keys, slot, ec.n_records)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            dedup_keys(keys, slot, ec.n_records)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
        d_dev, d_host = device_events(lambda: dedup_keys(keys, slot, ec.n_records), n_ticks)
        prof_line["dedup_wall_ms"] = d_ms
        prof_line["dedup_share_of_tick_wall"] = d_ms / wall_ms
        prof_line["dedup_device_ops"] = len(d_dev) / n_ticks
        prof_line["dedup_host_top_level_ops"] = d_host
        prof_line["dedup_device_busy_ms"] = sum(e.time_range.elapsed_us() for e in d_dev) / 1e3 / n_ticks
    prof_line["profile_wall_s"] = time.perf_counter() - t_start
    log("profile: " + json.dumps(prof_line))


def ulps(a, b):
    """Largest float32 ulp distance between two same-sign arrays."""
    import numpy as np

    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def margins(logits):
    """Top-1 minus top-2 logit per (step, request): logits (G, B, V)."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu()


def decided_steps(margin_row, tol=LOGIT_TOL):
    """Steps 0.. up to and including the first whose margin is below 10x the
    tolerance: those tokens must agree; later ones may follow another token."""
    for s, m in enumerate(margin_row):
        if m < 10 * tol:
            return s + 1
    return len(margin_row)


def check_init(params, golden):
    """The card's init_lm against the reference's weights: samples (a
    corner of the leaf seen as rows of its last dim) within 2 ulp, sums of
    |w| within 1e-6 relative.  A layer's leaf is named after its stack
    (``layers/…``, ``enc_layers/…``, ``dec_layers/…``) at its layer."""
    for name, ref in golden["leaves"].items():
        parts = name.split("@")[0].split("/")  # a file may name a leaf once per layer, as name@layer
        t = params
        if ref["layer"] is not None:
            t = getattr(t, parts[0])[ref["layer"]]
            parts = parts[1:]
        for part in parts:
            t = getattr(t, part)
        rows = t.reshape(-1, t.shape[-1])
        sample = rows[:2, :8] if ref["corner"] == "head" else rows[-2:, -8:]
        d = ulps(sample.cpu().numpy(), ref["sample"])
        # float64 sums of slabs of at most 2**26 elements: a whole float64 copy of a large leaf (nemotron-4-15b's
        # embedding, 12.6 GB) does not fit beside a 62.5 GB model
        total = sum(float(c.double().abs().sum()) for c in rows.split(max(1, (1 << 26) // rows.shape[1])))
        rel = abs(total - ref["abs_sum"]) / ref["abs_sum"]
        log(f"  init {name}: sample within {d} ulp, sum |w| {total:.6f} vs {ref['abs_sum']:.6f} (rel {rel:.2e})")
        if d > 2 or rel > 1e-6:
            raise AssertionError(f"init_lm on the card differs from the reference at {name}")


def check_golden(res, golden, tol=LOGIT_TOL):
    """A kernel-plane serve at the golden file's size against the JAX
    reference's full-width outputs: logits within ``tol``, greedy tokens
    equal over the decided steps."""
    import torch

    if res.prompts.cpu().tolist() != golden["prompts"]:
        raise AssertionError("golden: prompts differ from the reference's randint(PRNGKey(1))")
    worst = 0.0
    for b in range(golden["batch"]):
        ref_m = [st["top_logits"][b][0] - st["top_logits"][b][1] for st in golden["steps"]]
        n = decided_steps(ref_m, tol)
        for s in range(n):
            st = golden["steps"][s]
            lg = res.logits[s, b].double().cpu()
            ids = torch.tensor(st["top_ids"][b])
            got = [lg[ids], lg.max(), torch.logsumexp(lg, 0)]
            want = [torch.tensor(st["top_logits"][b], dtype=torch.float64), torch.tensor(st["max"][b]),
                    torch.tensor(st["lse"][b])]
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"golden: request {b} step {s}: logits off by {err} > {tol}")
            if ref_m[s] > 10 * tol and int(lg.argmax()) != st["top_ids"][b][0]:
                raise AssertionError(f"golden: request {b} step {s}: top-1 {int(lg.argmax())} != {st['top_ids'][b][0]}")
            if int(res.tokens[b, s]) != golden["tokens"][b][s]:
                raise AssertionError(f"golden: request {b} step {s}: token {int(res.tokens[b, s])} != "
                                     f"{golden['tokens'][b][s]}")
        log(f"  golden request {b}: {n} of {golden['gen_len']} steps decided (margin > {10 * tol}); "
            f"tokens equal, logits within {tol}")
    return worst


def device_busy(fn, prefix="moe:", cpu=True):
    """Wall ms of one synchronised call, the device's busy ms in it
    (torch.profiler: the sum of the device operations' durations), their
    count, the largest kernel families: name -> [launches, ms], and the
    launches and ms of the layer steps named ``prefix``* (``range_split``:
    empty without the layer's ``Record`` open: ``moe:``, ``ssm:`` or
    ``rglru:``).  ``cpu=False`` traces the device alone: no host operation
    and no range is recorded, which cuts the trace's cost for a call of
    many operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's operations; a profiler range also shows on the device's timeline: not one
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RANGE_PREFIXES)]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    fams = {}
    for e in dev:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        fam = fams.setdefault(name.split("(")[0].strip()[:80], [0, 0.0])
        fam[0] += 1
        fam[1] += e.time_range.elapsed_us() / 1e3
    top = dict(sorted(fams.items(), key=lambda kv: -kv[1][1])[:8])
    return out, wall, busy, len(dev), top, range_split(prof.events(), prefix)


def phase_serve(counted):
    """The LM serving path at full width on the card: init_lm from seed 0,
    the golden-file run, a profiled prefill and decode step, then the main
    path: serve() at SERVE on the kernel plane, launches counted from 0, and
    the same requests on the torch plane.  Returns the kernel plane's
    launches by kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import init_lm

    cfg, _ = get_config("stablelm-1.6b")
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_stablelm.json")) as f:
        golden = json.load(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve: init_lm({cfg.name}, seed 0) on the card: {n_params:,} parameters in "
        f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # the config's analytic count takes one d_model vector per norm; a layernorm also has a bias,
    # and the final norm is not counted
    if n_params != cfg.param_count() + 2 * cfg.d_model * (cfg.n_layers + 1):
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + norms")
    check_init(params, golden)

    g = serve(cfg, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=params)
    err = check_golden(g, golden)
    log(f"serve golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, kernel plane): "
        f"logits within {err:.3e} of the JAX reference (tolerance {LOGIT_TOL}), tokens {g.tokens.tolist()}")

    # where the time goes: one prefill and one decode step at the main path's shape, profiled
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (SERVE["batch"], SERVE["prompt_len"]), 0, cfg.vocab_size)
        pad = SERVE["prompt_len"] + SERVE["gen_len"]
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]}, pad_to=96, plane="kernel")  # warm-up
        (logits, cache), p_wall, p_busy, p_ops, p_top, _ = device_busy(
            lambda: lm_prefill(params, cfg, {"tokens": prompts}, pad_to=pad, plane="kernel"))
        tok = logits.argmax(-1)
        lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: writes slot S, which the next call rewrites
        _, d_wall, d_busy, d_ops, d_top, _ = device_busy(lambda: lm_decode_step(params, cfg, cache, {"token": tok}))
        del cache, logits
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    log(f"main path {SERVE_PATH} (kernel plane, B={SERVE['batch']}, prompt {SERVE['prompt_len']}, "
        f"{SERVE['gen_len']} tokens each, float32): prefill {k.prefill_ms:.3f} ms, decode {k.decode_ms_per_step:.3f} "
        f"ms/step, {k.tokens_per_s:.1f} tok/s, page table {k.pages_used}/{k.pages_total} used, "
        f"{k.pages_used_after_release} after release, launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    if got != expect:
        raise AssertionError(f"{SERVE_PATH}: kernel launches {got} != {expect} (one flash_attention per prefill layer)")

    t = serve(cfg, **SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {SERVE_PATH} (torch plane): prefill {t.prefill_ms:.3f} ms, decode {t.decode_ms_per_step:.3f} "
        f"ms/step, {t.tokens_per_s:.1f} tok/s")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > LOGIT_TOL:
        raise AssertionError(f"{SERVE_PATH}: prefill logits of the planes differ by {gap} > {LOGIT_TOL}")
    m = margins(t.logits)
    for b in range(SERVE["batch"]):
        n = decided_steps(m[:, b].tolist())
        if k.tokens[b, :n].tolist() != t.tokens[b, :n].tolist():
            raise AssertionError(f"{SERVE_PATH}: request {b}: greedy tokens differ within the first {n} steps")
        log(f"  request {b}: tokens equal over the {n} decided steps of {SERVE['gen_len']} "
            f"({int((k.tokens[b] == t.tokens[b]).sum())} equal in all)")
    log(f"{SERVE_PATH}: prefill logits of the planes within {gap:.3e} (tolerance {LOGIT_TOL}); "
        f"logits std {float(k.logits[0].std()):.3f}")
    return got


MOE_STEPS = ("router", "dispatch", "expert products", "combine")  # moe.Record's profiler ranges
RANGE_PREFIXES = ("moe:", "ssm:", "rglru:")  # the profiler ranges of moe.Record, ssm.Record and rglru.Record


def range_split(events, prefix="moe:"):
    """Device ms and launches under each profiler range whose name starts
    with ``prefix``: {name: [launches, ms]}, the device operations that
    start inside the range's span on the device's timeline (the profiler
    draws a range there from its first kernel's start to its last's end;
    one stream, so the spans do not overlap).  The kernels correlated to a
    range's CPU operations are not read: at tens of thousands of device
    operations they were over-counted (a full-depth SSM prefill)."""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in events
                 if e.device_type == cuda and not e.name.startswith(RANGE_PREFIXES))
    starts = [t for t, _ in ops]
    out = {}
    for e in events:
        if e.device_type == cuda and e.name.startswith(prefix):
            lo, hi = bisect.bisect_left(starts, e.time_range.start), bisect.bisect_left(starts, e.time_range.end)
            row = out.setdefault(e.name[len(prefix):], [0, 0.0])
            row[0] += hi - lo
            row[1] += sum(d for _, d in ops[lo:hi]) / 1e3
    return out


def moe_serve_work(cfg, B, S, kept, n_rows):
    """(flops, bytes) a float32 prefill of B x S tokens needs on the MoE
    model, and the bytes of one decode step.  Operations: 2 per weight per
    token for the projections and the router, 2 per expert weight per
    filled capacity slot (``kept``: the assignments each layer kept in this
    run's prefill; an empty slot needs no work), 4 Dh per causal (query,
    key) pair and head, the head on the last token only.  Bytes: every
    weight read once, of the embedding only the rows the tokens read
    (``n_rows`` distinct rows in prefill, B in a decode step, whose experts
    all run on their C = 4 slots), the KV cache written once (prefill) or
    read once (decode)."""
    D, H, KV, Dh, F, E, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.n_experts,
                             cfg.vocab_size)
    T = B * S
    attn_w = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
    per_layer = 2 * T * (attn_w + D * E) + 4 * Dh * H * B * S * (S + 1) // 2
    flops = cfg.n_layers * per_layer + sum(2 * n * 3 * D * F for n in kept) + 2 * B * D * V
    weights = 4 * (cfg.param_count() + D - V * D)  # all but the embedding (not tied to the head)
    kv = 4 * 2 * cfg.n_layers * B * S * KV * Dh
    return flops, weights + 4 * n_rows * D + kv, weights + 4 * B * D + kv


def prefill_route(rec, cfg, layer, n_tokens):
    """``route_stats`` of layer ``layer``'s call in the prefill a
    ``moe.Record`` holds first (one call per layer, of all ``n_tokens``)."""
    from repro_torch.layers.moe import route_stats

    call = rec.calls[layer]
    if call["logits"].shape[0] != n_tokens:
        raise AssertionError(f"moe.Record: call {layer} routed {call['logits'].shape[0]} tokens, not {n_tokens}")
    return route_stats(cfg, call)


def phase_serve_moe(counted):
    """The MoE serving path at full width on the card: llama4-scout-17b-a16e
    cut to MOE_LAYERS layers, init_lm from seed 0 (checked against the
    reference's weights), the golden-file run on the first two layers of the
    same model (routing per layer, logits and greedy tokens), a profiled
    prefill and decode step with the MoE layer's time split by step, then
    the main path: serve() at SERVE on the kernel plane, launches counted
    from 0, and the same requests on the torch plane.  Returns the kernel
    plane's launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.layers import moe
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import LM, init_lm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH)[0], n_layers=MOE_LAYERS)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_llama4_scout.json")) as f:
        golden = json.load(f)
    tol, router_gap = golden["tolerance"]["logits"], golden["port_cpu_gap"]["router_logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve moe: init_lm({cfg.name}, {cfg.n_layers} of 48 layers, seed 0) on the card: {n_params:,} parameters "
        f"in {time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # the config's analytic count takes one d_model vector per rmsnorm; the final norm is not counted
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + the final norm")
    check_init(params, golden)

    # the golden run: the first layers of the same model (layer l's key does not depend on the depth)
    cfg2 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
    two = LM(cfg2, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg2.n_layers]))
    with moe.Record() as rec:
        g = serve(cfg2, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
                  page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=two)
    for layer, ref in enumerate(golden["routing"]):
        mine = prefill_route(rec, cfg2, layer, golden["batch"] * golden["prompt_len"])
        held = ref["margin"] > 10 * router_gap
        same = (mine["loads"], mine["dropped"]) == (ref["loads"], ref["dropped"])
        log(f"  golden routing layer {layer}: dropped {mine['dropped']} of {sum(mine['loads'])} (reference "
            f"{ref['dropped']}), loads {'equal' if mine['loads'] == ref['loads'] else mine['loads']}, reference "
            f"margin {ref['margin']:.3e} {'>' if held else '<='} 10x the CPU router-logit gap {router_gap:.3e}"
            + ("" if held else ": not held"))
        if held and not same:
            raise AssertionError(f"golden: layer {layer} routes {mine} where the reference routes {ref}")
    err = check_golden(g, golden, tol)
    log(f"serve moe golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, "
        f"{cfg2.n_layers} layers, kernel plane): logits within {err:.3e} of the JAX reference (tolerance {tol}), "
        f"tokens {g.tokens.tolist()}")
    del two, g, rec

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, the MoE by step
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]}, pad_to=96, plane="kernel")  # warm-up
        with moe.Record() as rec:
            (logits, cache), p_wall, p_busy, p_ops, p_top, p_split = device_busy(
                lambda: lm_prefill(params, cfg, {"tokens": prompts}, pad_to=S + G, plane="kernel"))
            tok = logits.argmax(-1)
            lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: writes slot S, which the next call rewrites
            _, d_wall, d_busy, d_ops, d_top, d_split = device_busy(
                lambda: lm_decode_step(params, cfg, cache, {"token": tok}))
        n_rows = int(prompts.unique().numel())
        del cache, logits
    if set(p_split) != set(MOE_STEPS) or set(d_split) != set(MOE_STEPS):
        raise AssertionError(f"moe.Record: the trace holds the ranges {sorted(p_split)}, {sorted(d_split)}")
    # the profiled prefill's routing: the expert work its filled slots need
    kept = [sum(r["loads"]) - r["dropped"] for r in (prefill_route(rec, cfg, i, B * S) for i in range(cfg.n_layers))]
    del rec
    flops, p_bytes, d_bytes = moe_serve_work(cfg, B, S, kept, n_rows)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12,
            "prefill_kept_assignments_per_layer": kept,
            "prefill_moe_launches_and_ms_by_step": p_split,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_bound_ms": d_bound, "decode_step_moe_launches_and_ms_by_step": d_split,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve moe profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    with moe.Record() as rk:
        k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {MOE_SERVE_PATH} (kernel plane, {cfg.n_layers} layers, B={B}, prompt {S}, {G} tokens each, "
        f"float32): prefill {k.prefill_ms:.3f} ms, decode {k.decode_ms_per_step:.3f} ms/step, {k.tokens_per_s:.1f} "
        f"tok/s, peak {peak:.3f} GB allocated, page table {k.pages_used}/{k.pages_total} used, "
        f"{k.pages_used_after_release} after release, launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    if got != expect:
        raise AssertionError(f"{MOE_SERVE_PATH}: kernel launches {got} != {expect} (one flash_attention per prefill "
                             "layer)")

    with moe.Record() as rt:
        t = serve(cfg, **SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {MOE_SERVE_PATH} (torch plane): prefill {t.prefill_ms:.3f} ms, decode "
        f"{t.decode_ms_per_step:.3f} ms/step, {t.tokens_per_s:.1f} tok/s")
    # what each plane's prefill routed, layer by layer
    for layer in range(cfg.n_layers):
        a, b = prefill_route(rk, cfg, layer, B * S), prefill_route(rt, cfg, layer, B * S)
        gap = float((rk.calls[layer]["logits"] - rt.calls[layer]["logits"]).abs().max())
        log(f"  {MOE_SERVE_PATH} layer {layer}: dropped {a['dropped']} of {sum(a['loads'])} (capacity "
            f"{a['capacity']}), loads {a['loads']}, smallest router margin {a['margin']:.3e}; planes' router logits "
            f"within {gap:.3e}, routing {'equal' if (a['loads'], a['dropped']) == (b['loads'], b['dropped']) else b}")
        if a["margin"] > 10 * gap and (a["loads"], a["dropped"]) != (b["loads"], b["dropped"]):
            raise AssertionError(f"{MOE_SERVE_PATH}: layer {layer}: the planes route differently: {a} vs {b}")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > tol:
        raise AssertionError(f"{MOE_SERVE_PATH}: prefill logits of the planes differ by {gap} > {tol}")
    m = margins(t.logits)
    for b in range(B):
        n = decided_steps(m[:, b].tolist(), tol)
        if k.tokens[b, :n].tolist() != t.tokens[b, :n].tolist():
            raise AssertionError(f"{MOE_SERVE_PATH}: request {b}: greedy tokens differ within the first {n} steps")
        log(f"  request {b}: tokens equal over the {n} decided steps of {G} "
            f"({int((k.tokens[b] == t.tokens[b]).sum())} equal in all)")
    log(f"{MOE_SERVE_PATH}: prefill logits of the planes within {gap:.3e} (tolerance {tol}); "
        f"logits std {float(k.logits[0].std()):.3f}; prefill {k.prefill_ms / p_bound:.2f}x its bound "
        f"{p_bound:.3f} ms, decode {k.decode_ms_per_step / d_bound:.2f}x its bound {d_bound:.3f} ms")
    del k, t, rk, rt
    gc.collect()
    torch.cuda.empty_cache()
    return got, params


def builder_serve(cfg, params, shd, B, P, G, seed=0):
    """serve()'s requests and greedy loop through ``train.steps``'
    builders on ``shd``'s mesh (None: one device), kernel plane: prompts
    ``randint(PRNGKey(seed + 1))``, a prefill with G slots of headroom, G - 1
    decode steps; the prefill and decode times of the loop, synchronised."""
    import types

    import torch

    from repro_torch.core import prng
    from repro_torch.train.steps import build_decode_step, build_prefill

    prefill, decode = build_prefill(cfg, shd), build_decode_step(cfg, shd)
    prompts = prng.randint(prng.prng_key(seed + 1, "cuda"), (B, P), 0, cfg.vocab_size)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts}, P + G, plane="kernel")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1)
        out, steps = [tok], [logits]
        for _ in range(G - 1):
            logits, cache = decode(params, cache, {"token": tok})
            tok = logits.argmax(-1)
            out.append(tok)
            steps.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    logits = torch.stack(steps)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("builder_serve: non-finite logits")
    return types.SimpleNamespace(prompts=prompts, tokens=torch.stack(out, 1), logits=logits,
                                 prefill_ms=(t1 - t0) * 1e3, decode_ms_per_step=(t2 - t1) * 1e3 / max(G - 1, 1))


def phase_serve_moe_mesh(counted, params):
    """llama4-scout at full width on a 1 x 4 mesh of shards on the one card,
    on the MoE phase's parameters (no second init): the golden-file run on
    the first two layers through the mesh (routing held where the
    reference's margin allows, logits and decided tokens); then at 6 layers
    and SERVE the builders' prefill and decode with and without the mesh in
    turns (times, device busy and idle share of a profiled prefill and
    decode step, peak memory, the paths' logits), the mesh path's launches
    counted from 0: one flash_attention per prefill layer, no other kernel;
    the mesh path may exceed the unsharded path's peak by less than one
    shard's slice of one expert weight (so no shard copied a weight); then
    the dry run over every (arch x shape x mesh) cell.  Returns the mesh
    path's launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.core import prng
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.layers import moe
    from repro_torch.models.lm import LM
    from repro_torch.sharding import AxisRules
    from repro_torch.train.steps import build_decode_step, build_prefill

    cfg = params.cfg
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_llama4_scout.json")) as f:
        golden = json.load(f)
    tol, router_gap = golden["tolerance"]["logits"], golden["port_cpu_gap"]["router_logits"]
    shd = AxisRules(make_host_mesh(*MESH_SHAPE, devices=("cuda",) * (MESH_SHAPE[0] * MESH_SHAPE[1])),
                    get_config(MOE_ARCH)[1])
    home = params.embed.device
    if any(d != home for d in shd.mesh.devices.flat):
        raise AssertionError(f"{MESH_SERVE_PATH}: mesh {shd.mesh} is not all on the parameters' device {home}")
    log(f"serve moe mesh: {shd.mesh}, {cfg.n_experts // MESH_SHAPE[1]} experts a shard")

    # (a) the golden run through the mesh: the first two layers of the same model
    cfg2 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
    two = LM(cfg2, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg2.n_layers]))
    with moe.Record() as rec:
        g = builder_serve(cfg2, two, shd, golden["batch"], golden["prompt_len"], golden["gen_len"], golden["seed"])
    for layer, ref in enumerate(golden["routing"]):
        mine = prefill_route(rec, cfg2, layer, golden["batch"] * golden["prompt_len"])
        held = ref["margin"] > 10 * router_gap
        same = (mine["loads"], mine["dropped"]) == (ref["loads"], ref["dropped"])
        log(f"  golden routing on the mesh, layer {layer}: dropped {mine['dropped']} of {sum(mine['loads'])} "
            f"(reference {ref['dropped']}), loads {'equal' if mine['loads'] == ref['loads'] else mine['loads']}"
            + ("" if held else ": not held (margin)"))
        if held and not same:
            raise AssertionError(f"{MESH_SERVE_PATH} golden: layer {layer} routes {mine} where the reference routes "
                                 f"{ref}")
    err = check_golden(g, golden, tol)
    log(f"{MESH_SERVE_PATH} golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, "
        f"{cfg2.n_layers} layers, S = {golden['prompt_len'] + golden['gen_len']} over {MESH_SHAPE[1]} shards): "
        f"logits within {err:.3e} of the JAX reference (tolerance {tol}), tokens {g.tokens.tolist()}")
    del two, g, rec

    # (b) the main path at 6 layers and SERVE, without and with the mesh, in turns (A B B A); a profiled
    # prefill and decode step of each path before its first timed run
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    if (S + G) % MESH_SHAPE[1]:
        raise AssertionError(f"{MESH_SERVE_PATH}: S = {S + G} does not split over {MESH_SHAPE[1]} shards")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    res, prof = {"unsharded": [], "1x4": []}, {}
    for name, rules in (("unsharded", None), ("1x4", shd), ("1x4", shd), ("unsharded", None)):
        if name not in prof:
            prefill, decode = build_prefill(cfg, rules), build_decode_step(cfg, rules)
            with torch.inference_mode():
                prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
                (logits, cache), p_wall, p_busy, p_ops, _, _ = device_busy(
                    lambda: prefill(params, {"tokens": prompts}, S + G, plane="kernel"))
                tok = logits.argmax(-1)
                decode(params, cache, {"token": tok})  # warm-up: writes slot S, which the next call rewrites
                _, d_wall, d_busy, d_ops, _, _ = device_busy(lambda: decode(params, cache, {"token": tok}))
                del logits, cache
            prof[name] = {"prefill_profiled_wall_ms": p_wall, "prefill_device_busy_ms": p_busy,
                          "prefill_idle_share": 1 - p_busy / p_wall, "prefill_device_ops": p_ops,
                          "decode_step_profiled_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
                          "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        r = builder_serve(cfg, params, rules, B, S, G)
        got = {fn.__name__: fn.launches for fn in counted}
        if got != expect:  # (c) one flash_attention per prefill layer, no other kernel, on either path
            raise AssertionError(f"{MESH_SERVE_PATH if rules else MOE_SERVE_PATH}: launches {got} != {expect}")
        if rules is not None and not res["1x4"]:
            mesh_got = got
        r.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res[name].append(r)
        log(f"main path {MESH_SERVE_PATH if rules is not None else MOE_SERVE_PATH + ' (builders, no mesh)'} "
            f"({cfg.n_layers} layers, B={B}, prompt {S}, {G} tokens each, kernel plane): prefill "
            f"{r.prefill_ms:.3f} ms, decode {r.decode_ms_per_step:.3f} ms/step, peak {r.peak_gb:.3f} GB, "
            f"launches {got}")
    for name, runs in res.items():
        prof[name].update(prefill_ms=[r.prefill_ms for r in runs], peak_gb=[r.peak_gb for r in runs],
                          decode_ms_per_step=[r.decode_ms_per_step for r in runs])
    log("serve moe mesh profile: " + json.dumps(prof))
    u, m = res["unsharded"][0], res["1x4"][0]
    gap_prefill = float((u.logits[0] - m.logits[0]).abs().max())
    same_in = 1  # steps whose inputs (every earlier token) agree on both paths
    while same_in < G and torch.equal(u.tokens[:, :same_in], m.tokens[:, :same_in]):
        same_in += 1
    gap = float((u.logits[:same_in] - m.logits[:same_in]).abs().max())
    if gap > tol:
        raise AssertionError(f"{MESH_SERVE_PATH}: logits {gap} off the unsharded path's (tolerance {tol})")
    mg = margins(u.logits)
    for b in range(B):
        n = decided_steps(mg[:, b].tolist(), tol)
        if u.tokens[b, :n].tolist() != m.tokens[b, :n].tolist():
            raise AssertionError(f"{MESH_SERVE_PATH}: request {b}: greedy tokens differ within the first {n} steps")
    # a shard that copied its expert weights would add at least one shard's slice of one layer's wg
    slice_gb = params.layers[0].moe.wg[: cfg.n_experts // MESH_SHAPE[1]].nbytes / 1e9
    extra = max(prof["1x4"]["peak_gb"]) - min(prof["unsharded"]["peak_gb"])
    if extra >= slice_gb:
        raise AssertionError(f"{MESH_SERVE_PATH}: peak {extra:.3f} GB over the unsharded path's: a weight copy")
    log(f"{MESH_SERVE_PATH}: launches {mesh_got}; prefill logits within {gap_prefill:.3e} of the unsharded path's, "
        f"logits of the first {same_in} steps within {gap:.3e} (tolerance {tol}); tokens equal over the decided "
        f"steps ({int((u.tokens == m.tokens).sum())} of {B * G} equal); peak {extra:+.3f} GB against the unsharded "
        f"path (one shard's expert slice {slice_gb:.3f} GB)")
    del res, u, m

    # (d) the dry run: every (arch x shape x mesh) cell laid out on the logical production meshes
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(a, s, mp) for a in ARCH_IDS for s in SHAPES for mp in (False, True)]
    wall = time.perf_counter() - t0
    errors = [r for r in recs if r["status"] == "error"]
    if errors or len(recs) != 8 * len(ARCH_IDS):
        raise AssertionError(f"dry run: {len(recs)} records, errors "
                             f"{[(r['arch'], r['shape'], r['error']) for r in errors]}")
    n_ok = sum(r["status"] == "ok" for r in recs)
    scout = next(r for r in recs if (r["arch"], r["shape"], r["mesh"]) == (MOE_ARCH, "train_4k", "16x16"))
    log(f"dry run: {len(recs)} cells in {wall:.3f} s, {n_ok} ok, {len(recs) - n_ok} skip; {MOE_ARCH} train_4k 16x16: "
        f"{scout['params_bytes_per_device']:,} parameter bytes a device, {scout['per_device_bytes']:,} in all")
    return mesh_got


def ssm_serve_work(cfg, n_params, B, S):
    """(flops, bytes) a float32 prefill of B x S tokens needs on the SSM
    model, and the bytes of one decode step.  Operations: 2 per weight per
    token for the weight products (in_proj, x_proj, dt_proj, out_proj), the
    head on the last token only; the elementwise work (the conv, the
    step sizes, the scan's about 6 operations per state element and
    token) is not counted, under 2 % of the products.  Bytes: every weight
    read once, of the embedding only the rows the tokens read (B in a
    decode step, ``S * B`` at most in prefill), the state h and the conv
    tail written once (prefill) or read and written once (decode);
    ``n_params`` is the model's parameter count."""
    D, di, N, R, K, V = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv, cfg.vocab_size
    per_token = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    flops = 2 * B * S * per_token * cfg.n_layers + 2 * B * D * V
    weights = 4 * (n_params - V * D)  # all but the embedding (not tied to the head)
    state = 4 * cfg.n_layers * B * (di * N + (K - 1) * di)
    return flops, weights + 4 * B * S * D + state, weights + 4 * B * D + 2 * state


def phase_serve_ssm(counted):
    """The SSM serving path at full width on the card: falcon-mamba-7b
    cut to SSM_LAYERS layers, init_lm from seed 0 (checked against the
    reference's weights), the golden-file run on the first two layers of the
    same model, a profiled prefill and decode step with the SSM layer's
    device time split by step, then the main path: serve() at SERVE,
    launches counted from 0 (none: the path reaches no hand-written kernel;
    without attention the kernel and torch planes compute the same thing).
    Returns the launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.layers import ssm
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import LM, init_lm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(SSM_ARCH)[0], n_layers=SSM_LAYERS)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_falcon_mamba.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]["logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve ssm: init_lm({cfg.name}, {cfg.n_layers} of 64 layers, seed 0) on the card: {n_params:,} parameters "
        f"in {time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # an SSM block holds norm (D), in_proj (D x 2 di), conv_w (K x di), conv_b (di), x_proj (di x (R + 2N)),
    # dt_proj (R x di), dt_bias (di), A_log (di x N), Dp (di) and out_proj (di x D): 105,312,256 parameters at
    # falcon-mamba's widths.  The config's analytic count (the reference's formula) takes two d_model norms a
    # block, as an attention block has (norm1, norm2), and no conv_b: d_inner - d_model short a block; it
    # leaves out the final norm too
    D, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
    block = D + 2 * D * di + K * di + di + di * (R + 2 * N) + R * di + di + di * N + di + di * D
    if (sum(p.numel() for p in params.layers[0].parameters()) != block
            or n_params != cfg.param_count() + cfg.n_layers * (di - D) + D):
        raise AssertionError(f"init_lm: {n_params} parameters, a block {block}; config {cfg.param_count()} + "
                             "(d_inner - d_model) a block + the final norm")
    check_init(params, golden)

    # the golden run: the first layers of the same model (layer l's key does not depend on the depth)
    cfg2 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
    two = LM(cfg2, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg2.n_layers]))
    g = serve(cfg2, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=two)
    err = check_golden(g, golden, tol)
    log(f"serve ssm golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, "
        f"{cfg2.n_layers} layers): logits within {err:.3e} of the JAX reference (tolerance {tol}, 10x the port's "
        f"CPU gap {golden['port_cpu_gap']['logits']:.3e}), tokens {g.tokens.tolist()}")
    del two, g

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, the SSM by step
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    flops, p_bytes, d_bytes = ssm_serve_work(cfg, n_params, B, S)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]})  # warm-up
        with ssm.Record():
            (logits, cache), p_wall, p_busy, p_ops, p_top, p_split = device_busy(
                lambda: lm_prefill(params, cfg, {"tokens": prompts}), "ssm:")
            tok = logits.argmax(-1)
            lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: the profiled step decodes the next position
            _, d_wall, d_busy, d_ops, d_top, d_split = device_busy(
                lambda: lm_decode_step(params, cfg, cache, {"token": tok}), "ssm:")
        prof_logits = logits.float()
        del cache, logits
    if set(p_split) != set(SSM_STEPS) or set(d_split) != set(SSM_STEPS):
        raise AssertionError(f"ssm.Record: the trace holds the ranges {sorted(p_split)}, {sorted(d_split)}")
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12,
            "prefill_ssm_launches_and_ms_by_step": p_split,
            "prefill_scan_share_of_busy": p_split["scan"][1] / p_busy,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_bound_ms": d_bound, "decode_step_ssm_launches_and_ms_by_step": d_split,
            "decode_step_scan_share_of_busy": d_split["scan"][1] / d_busy,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve ssm profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {SSM_SERVE_PATH} (all {cfg.n_layers} layers, B={B}, prompt {S}, {G} tokens each, float32): "
        f"prefill {k.prefill_ms:.3f} ms ({k.prefill_ms / p_bound:.2f}x its bound {p_bound:.3f} ms: "
        f"{flops / 1e12:.2f} TFLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s), decode {k.decode_ms_per_step:.3f} "
        f"ms/step ({k.decode_ms_per_step / d_bound:.2f}x its bound {d_bound:.3f} ms: {d_bytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {k.tokens_per_s:.1f} tok/s, peak {peak:.3f} GB allocated, page table "
        f"{k.pages_used}/{k.pages_total} used, {k.pages_used_after_release} after release, launches {got}")
    if any(got.values()):
        raise AssertionError(f"{SSM_SERVE_PATH}: launched {got}; the SSM path runs no hand-written kernel")
    if not torch.equal(k.prompts, prompts):
        raise AssertionError(f"{SSM_SERVE_PATH}: serve's prompts are not randint(PRNGKey(1))")
    gap = float((k.logits[0] - prof_logits).abs().max())
    if gap > tol:
        raise AssertionError(f"{SSM_SERVE_PATH}: prefill logits {gap} from the profiled prefill's > {tol}")
    log(f"{SSM_SERVE_PATH}: prefill logits within {gap:.3e} of the profiled prefill's (tolerance {tol}); logits std "
        f"{float(k.logits[0].std()):.3f}; tokens {k.tokens.tolist()}")
    del params, k, prof_logits
    gc.collect()
    torch.cuda.empty_cache()
    return got


def hybrid_serve_work(cfg, n_params, B, S):
    """(flops, bytes) a float32 prefill of B x S tokens needs on the hybrid
    model, and the bytes of one decode step.  Operations: 2 per weight of a
    layer's matrices per token (the RG-LRU's in, gate and out projections,
    the attention's q, k, v and o, the GeGLU MLP's three), 4 Dh per unmasked
    (query, key) pair and head of an attention layer (keys within the
    window), the head on the last token only; the elementwise work (the
    conv, the gates, the scan, some 30 operations per channel and token) is
    not counted, under 1 % of the products.  Bytes: every weight read once,
    of the embedding only the rows the tokens read (B in a decode step,
    ``S * B`` at most in prefill), the window's rings and the RG-LRU states
    written once (prefill), or the rings read once and the states read and
    written (decode)."""
    D, F, Wr, H, KV, Dh, V, K, Win = (cfg.d_model, cfg.d_ff, cfg.rnn_width, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, cfg.vocab_size, cfg.ssm_conv, cfg.local_window)
    kinds = cfg.layer_kinds()
    n_attn, n_rec = kinds.count("attn"), kinds.count("rglru")
    mats = n_rec * (3 * D * Wr + 3 * D * F) + n_attn * (2 * D * H * Dh + 2 * D * KV * Dh + 3 * D * F)
    pairs = B * H * sum(min(q + 1, Win) for q in range(S))
    flops = 2 * B * S * mats + n_attn * 4 * Dh * pairs + 2 * B * D * V
    weights = 4 * (n_params - V * D)  # all but the embedding (not tied to the head)
    rings = 4 * n_attn * B * min(Win, S) * KV * Dh * 2
    states = 4 * n_rec * B * (Wr + (K - 1) * Wr)
    return flops, weights + 4 * B * S * D + rings + states, weights + 4 * B * D + rings + 2 * states


def phase_serve_hybrid(counted):
    """The hybrid serving path at full width and depth on the card:
    recurrentgemma-2b's 26 layers, init_lm from seed 0 (checked against the
    reference's weights), the golden-file run on the first group of the
    same model, a profiled prefill and decode step with the RG-LRU layer's
    device time split by step, then the main path: serve() at SERVE,
    launches counted from 0 (none: local attention takes the reference's
    XLA route on both planes, and the path reaches no hand-written kernel),
    and a torch-plane prefill of the same prompts, bitwise the kernel
    plane's.  Returns the launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.layers import rglru
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import LM, init_lm

    gc.collect()
    torch.cuda.empty_cache()
    cfg, _ = get_config(HYBRID_ARCH)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_recurrentgemma.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]["logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve hybrid: init_lm({cfg.name}, all {cfg.n_layers} layers, seed 0) on the card: {n_params:,} "
        f"parameters in {init_s:.3f} s, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # the model's count (the reference's init_lm tree).  The config's analytic count (the reference's formula)
    # is 511 M short: it takes two matrices for the geglu MLP, whose init_mlp builds three (gate, up, down), so
    # D x F a layer; and 2W for the RG-LRU's vectors (conv_b, wa, ba, wx, bx, lam: 6W) and no final norm
    D, F, Wr = cfg.d_model, cfg.d_ff, cfg.rnn_width
    if n_params != HYBRID_PARAMS or n_params != (cfg.param_count() + cfg.n_layers * D * F
                                                 + cfg.layer_kinds().count("rglru") * 4 * Wr + D):
        raise AssertionError(f"init_lm: {n_params} parameters, not {HYBRID_PARAMS} (config {cfg.param_count()} + "
                             "D x F a layer + 4W an RG-LRU layer + the final norm)")
    check_init(params, golden)

    # the golden run: the first group of the same model (a first-group layer's key does not depend on the depth)
    cfg3 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
    three = LM(cfg3, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg3.n_layers]))
    g = serve(cfg3, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=three)
    err = check_golden(g, golden, tol)
    log(f"serve hybrid golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, "
        f"{cfg3.n_layers} layers): logits within {err:.3e} of the JAX reference (tolerance {tol}, 10x the port's "
        f"CPU gap {golden['port_cpu_gap']['logits']:.3e}), tokens {g.tokens.tolist()}")
    if g.tokens.tolist() != golden["tokens"]:
        raise AssertionError(f"serve hybrid golden: tokens {g.tokens.tolist()} != {golden['tokens']}")
    del three, g

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, the RG-LRU by step
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    flops, p_bytes, d_bytes = hybrid_serve_work(cfg, n_params, B, S)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]})  # warm-up
        with rglru.Record():
            (logits, cache), p_wall, p_busy, p_ops, p_top, p_split = device_busy(
                lambda: lm_prefill(params, cfg, {"tokens": prompts}, pad_to=S + G), "rglru:")
            tok = logits.argmax(-1)
            lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: the profiled step decodes the next position
            _, d_wall, d_busy, d_ops, d_top, d_split = device_busy(
                lambda: lm_decode_step(params, cfg, cache, {"token": tok}), "rglru:")
        prof_logits = logits.float()
        del cache, logits
    if set(p_split) != set(HYBRID_STEPS) or set(d_split) != set(HYBRID_STEPS):
        raise AssertionError(f"rglru.Record: the trace holds the ranges {sorted(p_split)}, {sorted(d_split)}")
    rec_ms = lambda split: sum(ms for _, ms in split.values())  # noqa: E731
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12,
            "prefill_rglru_launches_and_ms_by_step": p_split, "prefill_rglru_share_of_busy": rec_ms(p_split) / p_busy,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_bound_ms": d_bound, "decode_step_rglru_launches_and_ms_by_step": d_split,
            "decode_step_rglru_share_of_busy": rec_ms(d_split) / d_busy,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve hybrid profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {HYBRID_SERVE_PATH} (all {cfg.n_layers} layers, B={B}, prompt {S}, {G} tokens each, float32): "
        f"prefill {k.prefill_ms:.3f} ms ({k.prefill_ms / p_bound:.2f}x its bound {p_bound:.3f} ms: "
        f"{flops / 1e12:.2f} TFLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s), decode {k.decode_ms_per_step:.3f} "
        f"ms/step ({k.decode_ms_per_step / d_bound:.2f}x its bound {d_bound:.3f} ms: {d_bytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {k.tokens_per_s:.1f} tok/s, peak {peak:.3f} GB allocated, page table "
        f"{k.pages_used}/{k.pages_total} used, {k.pages_used_after_release} after release, launches {got}")
    if any(got.values()):
        raise AssertionError(f"{HYBRID_SERVE_PATH}: launched {got}; the hybrid path runs no hand-written kernel")
    if not torch.equal(k.prompts, prompts):
        raise AssertionError(f"{HYBRID_SERVE_PATH}: serve's prompts are not randint(PRNGKey(1))")
    gap = float((k.logits[0] - prof_logits).abs().max())
    if gap > tol:
        raise AssertionError(f"{HYBRID_SERVE_PATH}: prefill logits {gap} from the profiled prefill's > {tol}")
    with torch.inference_mode():
        t_logits, _ = lm_prefill(params, cfg, {"tokens": prompts}, pad_to=S + G, plane="torch")
    if not torch.equal(t_logits.float(), k.logits[0]):
        raise AssertionError(f"{HYBRID_SERVE_PATH}: the torch plane's prefill logits differ from the kernel plane's "
                             f"by {float((t_logits.float() - k.logits[0]).abs().max())}")
    log(f"{HYBRID_SERVE_PATH}: the torch plane's prefill logits equal the kernel plane's bitwise; within "
        f"{gap:.3e} of the profiled prefill's (tolerance {tol}); logits std {float(k.logits[0].std()):.3f}; "
        f"tokens {k.tokens.tolist()}")
    del params, k, prof_logits, t_logits
    gc.collect()
    torch.cuda.empty_cache()
    return got


def whisper_serve_work(cfg, n_params, B, S, G):
    """(flops, bytes) a float32 prefill of B requests (T = ``enc_seq_len``
    frames and an S-token prompt each) needs on the encoder-decoder, and the
    bytes of one decode step at the run's mean position S + G / 2.
    Operations: 2 per weight of a layer's matrices per token (the encoder's
    q, k, v, o and MLP per frame; the decoder's self q, k, v, o, cross q, o
    and MLP per token, and its cross k and v per frame), 4 Dh per (query,
    key) pair and head (all T x T in the encoder, the causal prefix in the
    decoder's self-attention, all S x T in its cross-attention), the head
    on the last token only; biases, norms and the sinusoids are not
    counted.  Bytes: every weight read once (of the embedding only the rows
    the tokens read), the frames read, the self and cross caches written
    (prefill), or the decoder's weights and the head read, the valid self
    cache and the whole cross cache read and one token's self k/v written
    (decode)."""
    D, F, H, KV, Dh, V, T, L, Le = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                    cfg.vocab_size, cfg.enc_seq_len, cfg.n_layers, cfg.n_enc_layers)
    attn_w = 2 * D * H * Dh + 2 * D * KV * Dh
    mlp_w = 2 * D * F
    enc = 2 * B * T * Le * (attn_w + mlp_w) + Le * 4 * Dh * B * H * T * T
    dec = (2 * B * S * L * (attn_w + 2 * D * H * Dh + mlp_w) + 2 * B * T * L * 2 * D * KV * Dh
           + L * 4 * Dh * B * H * (S * (S + 1) // 2 + S * T))
    flops = enc + dec + 2 * B * D * V
    kv = 4 * 2 * L * B * KV * Dh  # bytes of one token's (or frame's) k and v over the decoder's layers
    weights = 4 * (n_params - V * D)  # all but the embedding (not tied to the head)
    p_bytes = weights + 4 * B * S * D + 4 * B * T * D + kv * (S + T)
    dec_weights = 4 * (n_params - V * D - Le * (4 * D * D + mlp_w + 9 * D + F) - 2 * D)  # no encoder, no enc_norm
    d_bytes = dec_weights + 4 * B * D + kv * (S + G // 2 + T) + kv
    return flops, p_bytes, d_bytes


def check_frames(frames, golden):
    """The frames' corners (rows of d_model) against the golden file's
    ``normal(PRNGKey(seed + 1))`` draw, within 2 ulp; returns the ulps."""
    rows = frames.reshape(-1, frames.shape[-1])
    d = max(ulps(rows[:2, :8].cpu().numpy(), golden["frames"]["head"]),
            ulps(rows[-2:, -8:].cpu().numpy(), golden["frames"]["tail"]))
    if d > 2:
        raise AssertionError(f"the frames on the card differ from the reference's normal(PRNGKey(1)) by {d} ulp")
    return d


def phase_serve_whisper(counted):
    """The encoder-decoder serving path at full width and depth on the card:
    whisper-small's 12 + 12 layers, init_lm from seed 0 (checked against the
    reference's weights, a cross-attention leaf among them, and the frames'
    draw), the golden-file run on the whole model, a profiled prefill and
    decode step (flash_attention launches counted in each), then the main
    path: serve() at WHISPER_SERVE, launches counted from 0 (24 a prefill:
    the encoder's non-causal calls and the decoder's causal ones; none in
    decode), and the same requests on the torch plane.  Returns the
    launches by kernel."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import init_lm

    gc.collect()
    torch.cuda.empty_cache()
    cfg, _ = get_config(WHISPER_ARCH)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_whisper.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]["logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    D, F = cfg.d_model, cfg.d_ff
    # the config's analytic count (the reference's formula) leaves out the biases and takes two norm vectors a
    # layer: 9D + F short a decoder layer, 7D + F an encoder layer, 4D for the final and encoder norms
    analytic = cfg.param_count()
    log(f"serve whisper: init_lm({cfg.name}, {cfg.n_enc_layers} + {cfg.n_layers} layers, seed 0) on the card: "
        f"{n_params:,} parameters (the config's analytic count {analytic:,}) in {init_s:.3f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    if n_params != WHISPER_PARAMS or n_params != (analytic + cfg.n_layers * (9 * D + F)
                                                  + cfg.n_enc_layers * (7 * D + F) + 4 * D):
        raise AssertionError(f"init_lm: {n_params} parameters, not {WHISPER_PARAMS}")
    check_init(params, golden)
    for layer in params.dec_layers:  # C.13: equal values in tensors of their own
        if not torch.equal(layer.xattn.wq, layer.attn.wq) or layer.xattn.wq.data_ptr() == layer.attn.wq.data_ptr():
            raise AssertionError("init_lm: a decoder layer's xattn is not attn's draw in storage of its own")

    # the golden run: the whole model, one request
    g = serve(cfg, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=params)
    d = check_frames(g.frames, golden)
    err = check_golden(g, golden, tol)
    log(f"serve whisper golden ({golden['batch']} x {cfg.enc_seq_len} frames + {golden['prompt_len']} tokens, "
        f"{golden['gen_len']} steps, all {cfg.n_enc_layers} + {cfg.n_layers} layers): frames within {d} ulp, "
        f"logits within {err:.3e} of the JAX reference (tolerance {tol}, 10x the port's CPU gap "
        f"{golden['port_cpu_gap']['logits']:.3e}), tokens {g.tokens.tolist()}")
    if g.tokens.tolist() != golden["tokens"]:
        raise AssertionError(f"serve whisper golden: tokens {g.tokens.tolist()} != {golden['tokens']}")
    del g

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, launches counted
    B, S, G = WHISPER_SERVE["batch"], WHISPER_SERVE["prompt_len"], WHISPER_SERVE["gen_len"]
    flops, p_bytes, d_bytes = whisper_serve_work(cfg, n_params, B, S, G)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        key = prng.prng_key(1, "cuda")
        prompts = prng.randint(key, (B, S), 0, cfg.vocab_size)
        frames = prng.normal(key, (B, cfg.enc_seq_len, D))
        batch = {"tokens": prompts, "frames": frames}
        lm_prefill(params, cfg, {"tokens": prompts[:, :16], "frames": frames}, plane="kernel")  # warm-up
        flash_attention.launches = 0
        (logits, cache), p_wall, p_busy, p_ops, p_top, _ = device_busy(
            lambda: lm_prefill(params, cfg, batch, pad_to=S + G, plane="kernel"))
        p_launches = flash_attention.launches
        tok = logits.argmax(-1)
        lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: the profiled step decodes the next position
        flash_attention.launches = 0
        _, d_wall, d_busy, d_ops, d_top, _ = device_busy(lambda: lm_decode_step(params, cfg, cache, {"token": tok}))
        d_launches = flash_attention.launches
        prof_logits = logits.float()
        del cache, logits
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_flash_attention_launches": p_launches,
            "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_flash_attention_launches": d_launches, "decode_step_bound_ms": d_bound,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log("serve whisper profile: " + json.dumps(prof))
    if (p_launches, d_launches) != (cfg.n_enc_layers + cfg.n_layers, 0):
        raise AssertionError(f"{WHISPER_SERVE_PATH}: flash_attention launched {p_launches} times in a prefill and "
                             f"{d_launches} in a decode step, not {cfg.n_enc_layers + cfg.n_layers} and 0")

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **WHISPER_SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {WHISPER_SERVE_PATH} (all {cfg.n_enc_layers} + {cfg.n_layers} layers, B={B}, {cfg.enc_seq_len} "
        f"frames, prompt {S}, {G} tokens each, float32): prefill {k.prefill_ms:.3f} ms ({k.prefill_ms / p_bound:.2f}x "
        f"its bound {p_bound:.3f} ms: {flops / 1e12:.3f} TFLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, "
        f"{p_bytes / 1e9:.3f} GB), decode {k.decode_ms_per_step:.3f} ms/step ({k.decode_ms_per_step / d_bound:.2f}x "
        f"its bound {d_bound:.3f} ms: {d_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"{k.tokens_per_s:.1f} tok/s, peak {peak:.3f} GB allocated, page table {k.pages_used}/{k.pages_total} used, "
        f"{k.pages_used_after_release} after release, launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_enc_layers + cfg.n_layers
    if got != expect:
        raise AssertionError(f"{WHISPER_SERVE_PATH}: kernel launches {got} != {expect} (one flash_attention per "
                             "encoder and decoder layer in the prefill, none in decode)")
    if not (torch.equal(k.prompts, prompts) and torch.equal(k.frames, frames)):
        raise AssertionError(f"{WHISPER_SERVE_PATH}: serve's prompts or frames are not the draws of PRNGKey(1)")
    gap = float((k.logits[0] - prof_logits).abs().max())
    if gap > tol:
        raise AssertionError(f"{WHISPER_SERVE_PATH}: prefill logits {gap} from the profiled prefill's > {tol}")

    t = serve(cfg, **WHISPER_SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {WHISPER_SERVE_PATH} (torch plane): prefill {t.prefill_ms:.3f} ms, decode "
        f"{t.decode_ms_per_step:.3f} ms/step, {t.tokens_per_s:.1f} tok/s")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > tol:
        raise AssertionError(f"{WHISPER_SERVE_PATH}: prefill logits of the planes differ by {gap} > {tol}")
    m = margins(t.logits)
    for b in range(B):
        n = decided_steps(m[:, b].tolist(), tol)
        if k.tokens[b, :n].tolist() != t.tokens[b, :n].tolist():
            raise AssertionError(f"{WHISPER_SERVE_PATH}: request {b}: greedy tokens differ within the first {n} steps")
        log(f"  request {b}: tokens equal over the {n} decided steps of {G} "
            f"({int((k.tokens[b] == t.tokens[b]).sum())} equal in all)")
    log(f"{WHISPER_SERVE_PATH}: prefill logits of the planes within {gap:.3e} (tolerance {tol}); logits std "
        f"{float(k.logits[0].std()):.3f}")
    del params, k, t, prof_logits
    gc.collect()
    torch.cuda.empty_cache()
    return got


def dense_serve_work(cfg, n_params, B, S, G):
    """(flops, bytes) a float32 prefill of B x S tokens needs on a dense
    model (the M-RoPE one too), and the bytes of one decode step at the
    run's mean cache length S + G / 2.  Operations: 2 per weight of a
    layer's matrices per token (q, k, v, o and the MLP's three, or two
    without a gate), 4 Dh per causal (query, key) pair and head (after the
    GQA repeat), the head on the last token only; biases, norms and the
    rotary are not counted.  Bytes: every weight read once (of an embedding
    apart from the head only the B x S rows the tokens read, at most; a
    tied one is the head, read whole), the KV cache written (prefill), or
    the weights and the head read, B embedding rows, the valid KV cache read
    and one token's k/v written (decode)."""
    D, F, H, KV, Dh, V, L = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size,
                             cfg.n_layers)
    n_mat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    layer_w = 2 * D * H * Dh + 2 * D * KV * Dh + n_mat * D * F
    flops = 2 * B * S * L * layer_w + L * 4 * Dh * B * H * (S * (S + 1) // 2) + 2 * B * D * V
    kv = 4 * 2 * L * B * KV * Dh  # bytes of one token's k and v over the layers
    if cfg.tie_embeddings:
        weights, rows = 4 * n_params, 0
    else:
        weights, rows = 4 * (n_params - V * D), 4 * D
    p_bytes = weights + rows * min(B * S, V) + kv * S
    d_bytes = weights + rows * B + kv * (S + G // 2) + kv
    return flops, p_bytes, d_bytes


def phase_serve_vlm(counted):
    """The M-RoPE VLM serving path at full width on the card: qwen2-vl-72b
    cut to VLM_LAYERS layers, init_lm from seed 0 (its parameter count and
    leaf corners against the reference's), the golden-file run on the first
    two layers of the same model (one 2048-token request holding a 32 x 32
    image grid, whose decode positions run behind the cache length), a
    profiled prefill and decode step (flash_attention launches counted in
    each), then the main path: serve() at SERVE on the kernel plane,
    launches counted from 0 (one flash_attention a prefill layer, none in
    decode), and the same requests on the torch plane.  Returns the
    launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import LM, init_lm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(VLM_ARCH)[0], n_layers=VLM_LAYERS)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_qwen2_vl.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]["logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve vlm: init_lm({cfg.name}, {cfg.n_layers} of 80 layers, seed 0) on the card: {n_params:,} parameters "
        f"(the config's analytic count {cfg.param_count():,}) in {init_s:.3f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # the config's analytic count takes one d_model vector per rmsnorm and the QKV biases; the final norm is not
    # counted
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + the final norm")
    check_init(params, golden)

    # the golden run: the first layers of the same model (layer l's key does not depend on the depth), one request
    # with the golden file's image, decoded at positions behind the cache length
    cfg2 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
    two = LM(cfg2, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg2.n_layers]))
    off, grid = golden["image"]
    g = serve(cfg2, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
              page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=two, image=(off, tuple(grid)))
    if g.positions[0].cpu().tolist() != golden["positions"]:
        raise AssertionError("serve vlm golden: the prompt's M-RoPE positions are not the golden file's")
    err = check_golden(g, golden, tol)
    same = g.tokens.tolist() == golden["tokens"]
    log(f"serve vlm golden ({golden['batch']} x {golden['prompt_len']} with a {grid[0]}x{grid[1]}x{grid[2]} image "
        f"at {off}, {golden['gen_len']} steps at positions {golden['decode_positions'][0]}.. from cache length "
        f"{golden['prompt_len']}, {cfg2.n_layers} layers, kernel plane): logits within {err:.3e} of the JAX "
        f"reference (tolerance {tol}, 10x the port's CPU gap {golden['port_cpu_gap']['logits']:.3e}), tokens "
        f"{g.tokens.tolist()} ({'all equal' if same else 'reference ' + str(golden['tokens'])})")
    del two, g

    got = serve_dense_model(counted, VLM_SERVE_PATH, cfg, params, n_params, tol, "of 80 layers")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def serve_dense_model(counted, path, cfg, params, n_params, tol, depth):
    """A dense model's profiled prefill and decode step at the main path's
    shape (flash_attention launches counted in each), then the main path:
    serve() at SERVE on the kernel plane, launches counted from 0 (one
    flash_attention a prefill layer, none in decode), and the same requests
    on the torch plane, whose prefill logits and decided tokens must agree
    within ``tol``.  An M-RoPE model takes the text-only positions.  Returns
    the launches by kernel."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import default_positions

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, launches counted
    B, S, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    flops, p_bytes, d_bytes = dense_serve_work(cfg, n_params, B, S, G)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    mrope = cfg.mrope_sections is not None
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
        batch = {"tokens": prompts}
        if mrope:
            batch["positions"] = default_positions(cfg, prompts)
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]}, pad_to=96, plane="kernel")  # warm-up
        flash_attention.launches = 0
        (logits, cache), p_wall, p_busy, p_ops, p_top, _ = device_busy(
            lambda: lm_prefill(params, cfg, batch, pad_to=S + G, plane="kernel"))
        p_launches = flash_attention.launches
        tok = logits.argmax(-1)
        step = {"token": tok}
        if mrope:
            step["positions"] = torch.full((B, 3), S, dtype=torch.int32, device="cuda")
        lm_decode_step(params, cfg, cache, step)  # warm-up: writes slot S, which the next call rewrites
        flash_attention.launches = 0
        _, d_wall, d_busy, d_ops, d_top, _ = device_busy(lambda: lm_decode_step(params, cfg, cache, step))
        d_launches = flash_attention.launches
        prof_logits = logits.float()
        del cache, logits
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_flash_attention_launches": p_launches,
            "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_flash_attention_launches": d_launches, "decode_step_bound_ms": d_bound,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log(f"{path} profile: " + json.dumps(prof))
    if (p_launches, d_launches) != (cfg.n_layers, 0):
        raise AssertionError(f"{path}: flash_attention launched {p_launches} times in a prefill and "
                             f"{d_launches} in a decode step, not {cfg.n_layers} and 0")

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    k = serve(cfg, **SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {path} (kernel plane, {cfg.n_layers} {depth}, B={B}, prompt {S}, {G} tokens each, "
        f"float32): prefill {k.prefill_ms:.3f} ms ({k.prefill_ms / p_bound:.2f}x its bound {p_bound:.3f} ms: "
        f"{flops / 1e12:.3f} TFLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, {p_bytes / 1e9:.3f} GB), decode "
        f"{k.decode_ms_per_step:.3f} ms/step ({k.decode_ms_per_step / d_bound:.2f}x its bound {d_bound:.3f} ms: "
        f"{d_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), {k.tokens_per_s:.1f} tok/s, peak {peak:.3f} GB "
        f"allocated, page table {k.pages_used}/{k.pages_total} used, {k.pages_used_after_release} after release, "
        f"launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    if got != expect:
        raise AssertionError(f"{path}: kernel launches {got} != {expect} (one flash_attention per prefill "
                             "layer, none in decode)")
    if not torch.equal(k.prompts, prompts) or (mrope and not torch.equal(k.positions, batch["positions"])):
        raise AssertionError(f"{path}: serve's prompts or positions are not randint(PRNGKey(1)) and the "
                             "text-only layout")
    gap = float((k.logits[0] - prof_logits).abs().max())
    if gap > tol:
        raise AssertionError(f"{path}: prefill logits {gap} from the profiled prefill's > {tol}")

    t = serve(cfg, **SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {path} (torch plane): prefill {t.prefill_ms:.3f} ms, decode "
        f"{t.decode_ms_per_step:.3f} ms/step, {t.tokens_per_s:.1f} tok/s")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > tol:
        raise AssertionError(f"{path}: prefill logits of the planes differ by {gap} > {tol}")
    m = margins(t.logits)
    for b in range(B):
        n = decided_steps(m[:, b].tolist(), tol)
        if k.tokens[b, :n].tolist() != t.tokens[b, :n].tolist():
            raise AssertionError(f"{path}: request {b}: greedy tokens differ within the first {n} steps")
        log(f"  request {b}: tokens equal over the {n} decided steps of {G} "
            f"({int((k.tokens[b] == t.tokens[b]).sum())} equal in all)")
    log(f"{path}: prefill logits of the planes within {gap:.3e} (tolerance {tol}); logits std "
        f"{float(k.logits[0].std()):.3f}")
    return got


def phase_serve_dense(counted):
    """The last three dense serving paths at full width on the card, one
    arch after another (``DENSE_LAYERS``: nemotron-4-15b, qwen2.5-32b,
    command-r-35b), each as ``phase_serve_vlm`` runs its model: init_lm
    from seed 0 (its parameter count and leaf corners against the
    reference's), the golden-file run on the model's first two layers (one
    2048-token prompt, 8 greedy tokens), a profiled prefill and decode step
    (flash_attention launches counted in each), then the main path: serve()
    at SERVE on the kernel plane, launches counted from 0 (one
    flash_attention a prefill layer, none in decode), and the same requests
    on the torch plane.  Each model is freed before the next.  Returns the
    launches by kernel of each path."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import LM, init_lm

    out = {}
    for arch, n_layers in DENSE_LAYERS.items():
        path = f"serve/{arch}"
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)[0]
        cfg = dataclasses.replace(full, n_layers=n_layers)
        with open(os.path.join(ROOT, "src", "repro_torch", "data", DENSE_GOLDEN[arch])) as f:
            golden = json.load(f)
        tol = golden["tolerance"]["logits"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        log(f"serve dense: init_lm({arch}, {n_layers} of {full.n_layers} layers, seed 0) on the card: "
            f"{n_params:,} parameters (the config's analytic count {cfg.param_count():,}) in {init_s:.3f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
        # the analytic count takes two d_model norm scales a layer, a parallel block has one, and the final norm
        # is not counted (no norm here has a bias)
        want = cfg.param_count() + cfg.d_model - (cfg.d_model * n_layers if cfg.parallel_block else 0)
        if n_params != want:
            raise AssertionError(f"{path}: init_lm made {n_params} parameters, not {want}")
        check_init(params, golden)

        # the golden run: the first layers of the same model (layer l's key does not depend on the depth)
        cfg2 = dataclasses.replace(cfg, n_layers=golden["n_layers"])
        two = LM(cfg2, params.embed, params.final_norm, params.lm_head, list(params.layers[: cfg2.n_layers]))
        g = serve(cfg2, batch=golden["batch"], prompt_len=golden["prompt_len"], gen_len=golden["gen_len"],
                  page_size=16, seed=golden["seed"], device="cuda", plane="kernel", params=two)
        err = check_golden(g, golden, tol)
        same = g.tokens.tolist() == golden["tokens"]
        log(f"{path} golden ({golden['batch']} x {golden['prompt_len']}, {golden['gen_len']} steps, "
            f"{cfg2.n_layers} layers, kernel plane): logits within {err:.3e} of the JAX reference (tolerance {tol}, "
            f"10x the port's CPU gap {golden['port_cpu_gap']['logits']:.3e}), tokens {g.tokens.tolist()} "
            f"({'all equal' if same else 'reference ' + str(golden['tokens'])})")
        del two, g

        out[path] = serve_dense_model(counted, path, cfg, params, n_params, tol, f"of {full.n_layers} layers")
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_windows(params, golden):
    """The card's expert leaves at the golden file's raw windows (a leaf's
    head, the elements around flat index 2**32, its tail: float32,
    base64) within 2 ulp of the reference's.  Returns the largest distance."""
    import base64

    import numpy as np

    worst = 0
    for name, wins in golden["windows"].items():
        t = params.layers[0]
        for part in name.split("/")[1:]:
            t = getattr(t, part)
        flat = t.reshape(-1)
        for w in wins:
            want = np.frombuffer(base64.b64decode(w["values"]), dtype="<f4")
            d = ulps(flat[w["start"]:w["start"] + w["n"]].cpu().numpy(), want)
            worst = max(worst, d)
            if d > 2:
                raise AssertionError(f"init_lm on the card differs from the reference at {name}[{w['start']}:]: {d} ulp")
        log(f"  init {name}: {len(wins)} windows of {wins[0]['n']} at flat "
            f"{[w['start'] for w in wins]} within {worst} ulp")
    return worst


def phase_serve_kimi(counted):
    """kimi-k2-1t-a32b at full width on the card, 1 of its 61 layers:
    init_lm from seed 0 (every leaf and the expert leaves' raw windows
    against the reference's), a profiled prefill and decode step at
    KIMI_SERVE's shape (flash_attention launches counted in each, the MoE
    split by step), then the main path: serve() at KIMI_SERVE on the kernel
    plane, launches counted from 0, whose first steps are the golden run
    (the same seed, prompt and length: logits, decided tokens, layer 0's
    routing), and the same request on the torch plane.  Returns the kernel
    plane's launches by kernel."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.layers import moe
    from repro_torch.models.decode import lm_decode_step, lm_prefill
    from repro_torch.models.lm import init_lm

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(KIMI_ARCH)[0]
    cfg = dataclasses.replace(full, n_layers=KIMI_LAYERS)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_serve_kimi_k2.json")) as f:
        golden = json.load(f)
    tol, router_gap = golden["tolerance"]["logits"], golden["port_cpu_gap"]["router_logits"]
    B, S, G = KIMI_SERVE["batch"], KIMI_SERVE["prompt_len"], KIMI_SERVE["gen_len"]
    if (golden["batch"], golden["prompt_len"], golden["n_layers"]) != (B, S, KIMI_LAYERS) or golden["gen_len"] > G:
        raise AssertionError("golden_serve_kimi_k2.json holds another run than the main path's first steps")
    free, total = torch.cuda.mem_get_info()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve kimi: init_lm({KIMI_ARCH}, {KIMI_LAYERS} of {full.n_layers} layers, seed 0) on the card: "
        f"{n_params:,} parameters (the config's analytic count {cfg.param_count():,}) in {init_s:.3f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated of the card's {total / 1e9:.3f} GB "
        f"({free / 1e9:.3f} GB free before)")
    # the analytic count takes one d_model vector per rmsnorm; the final norm is not counted
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + the final norm")
    check_init(params, golden)
    check_windows(params, golden)

    # where the time goes: one prefill and one decode step at the main path's shape, profiled, the MoE by step
    with torch.inference_mode():
        prompts = prng.randint(prng.prng_key(1, "cuda"), (B, S), 0, cfg.vocab_size)
        lm_prefill(params, cfg, {"tokens": prompts[:, :64]}, pad_to=96, plane="kernel")  # warm-up
        with moe.Record() as rec:
            flash_attention.launches = 0
            (logits, cache), p_wall, p_busy, p_ops, p_top, p_split = device_busy(
                lambda: lm_prefill(params, cfg, {"tokens": prompts}, pad_to=S + G, plane="kernel"))
            p_launches = flash_attention.launches
            tok = logits.argmax(-1)
            lm_decode_step(params, cfg, cache, {"token": tok})  # warm-up: writes slot S, which the next call rewrites
            flash_attention.launches = 0
            _, d_wall, d_busy, d_ops, d_top, d_split = device_busy(
                lambda: lm_decode_step(params, cfg, cache, {"token": tok}))
            d_launches = flash_attention.launches
        n_rows = int(prompts.unique().numel())
        prof_logits = logits.float()
        del cache, logits
    if (p_launches, d_launches) != (cfg.n_layers, 0):
        raise AssertionError(f"{KIMI_SERVE_PATH}: flash_attention launched {p_launches} times in a prefill and "
                             f"{d_launches} in a decode step, not {cfg.n_layers} and 0")
    kept = [sum(r["loads"]) - r["dropped"] for r in (prefill_route(rec, cfg, i, B * S) for i in range(cfg.n_layers))]
    del rec
    flops, p_bytes, d_bytes = moe_serve_work(cfg, B, S, kept, n_rows)
    p_bound = max(flops / FP32_FLOPS_PER_S, p_bytes / HBM_BYTES_PER_S) * 1e3
    d_bound = d_bytes / HBM_BYTES_PER_S * 1e3
    expert_bytes = 4 * cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    prof = {"prefill_wall_ms": p_wall, "prefill_device_busy_ms": p_busy, "prefill_idle_share": 1 - p_busy / p_wall,
            "prefill_device_ops": p_ops, "prefill_flash_attention_launches": p_launches,
            "prefill_bound_ms": p_bound, "prefill_tflop": flops / 1e12, "prefill_kept_assignments_per_layer": kept,
            "prefill_moe_launches_and_ms_by_step": p_split,
            "decode_step_wall_ms": d_wall, "decode_step_device_busy_ms": d_busy,
            "decode_step_idle_share": 1 - d_busy / d_wall, "decode_step_device_ops": d_ops,
            "decode_step_flash_attention_launches": d_launches, "decode_step_bound_ms": d_bound,
            "decode_step_expert_bytes_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_step_moe_launches_and_ms_by_step": d_split,
            "prefill_top_launches_and_ms": p_top, "decode_step_top_launches_and_ms": d_top}
    log(f"{KIMI_SERVE_PATH} profile: " + json.dumps(prof))

    # the main path: counts from 0, then read
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    with moe.Record() as rk:
        k = serve(cfg, **KIMI_SERVE, seed=0, device="cuda", plane="kernel", params=params)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {KIMI_SERVE_PATH} (kernel plane, {cfg.n_layers} of {full.n_layers} layers, B={B}, prompt {S}, "
        f"{G} tokens each, float32): prefill {k.prefill_ms:.3f} ms ({k.prefill_ms / p_bound:.2f}x its bound "
        f"{p_bound:.3f} ms: {flops / 1e12:.3f} TFLOP at {FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, {p_bytes / 1e9:.3f} GB), "
        f"decode {k.decode_ms_per_step:.3f} ms/step ({k.decode_ms_per_step / d_bound:.2f}x its bound {d_bound:.3f} ms: "
        f"{d_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; the expert weights alone "
        f"{expert_bytes / 1e9:.3f} GB, {expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms), {k.tokens_per_s:.1f} tok/s, "
        f"peak {peak:.3f} GB allocated, page table {k.pages_used}/{k.pages_total} used, "
        f"{k.pages_used_after_release} after release, launches {got}")
    expect = {fn.__name__: 0 for fn in counted}
    expect["flash_attention"] = cfg.n_layers
    if got != expect:
        raise AssertionError(f"{KIMI_SERVE_PATH}: kernel launches {got} != {expect} (one flash_attention per prefill "
                             "layer, none in decode)")
    gap = float((k.logits[0] - prof_logits).abs().max())
    if gap > tol:
        raise AssertionError(f"{KIMI_SERVE_PATH}: prefill logits {gap} from the profiled prefill's > {tol}")

    # the golden file: the reference's run is the main path's first steps (the same seed, prompt and length)
    ref = golden["routing"][0]
    mine = prefill_route(rk, cfg, 0, B * S)
    held = ref["margin"] > 10 * router_gap
    log(f"  golden routing layer 0: dropped {mine['dropped']} of {sum(mine['loads'])} (reference {ref['dropped']}), "
        f"loads {'equal' if mine['loads'] == ref['loads'] else mine['loads']}, reference margin {ref['margin']:.3e} "
        f"{'>' if held else '<='} 10x the CPU router-logit gap {router_gap:.3e}" + ("" if held else ": not held"))
    if held and (mine["loads"], mine["dropped"]) != (ref["loads"], ref["dropped"]):
        raise AssertionError(f"golden: layer 0 routes {mine} where the reference routes {ref}")
    err = check_golden(k, golden, tol)
    same = k.tokens[:, :golden["gen_len"]].tolist() == golden["tokens"]
    log(f"{KIMI_SERVE_PATH} golden ({golden['batch']} x {golden['prompt_len']}, the first {golden['gen_len']} steps, "
        f"kernel plane): logits within {err:.3e} of the JAX reference (tolerance {tol}, 10x the port's CPU gap "
        f"{golden['port_cpu_gap']['logits']:.3e}), tokens {k.tokens[:, :golden['gen_len']].tolist()} "
        f"({'all equal' if same else 'reference ' + str(golden['tokens'])})")

    with moe.Record() as rt:
        t = serve(cfg, **KIMI_SERVE, seed=0, device="cuda", plane="torch", params=params)
    log(f"main path {KIMI_SERVE_PATH} (torch plane): prefill {t.prefill_ms:.3f} ms, decode "
        f"{t.decode_ms_per_step:.3f} ms/step, {t.tokens_per_s:.1f} tok/s")
    a, b = prefill_route(rk, cfg, 0, B * S), prefill_route(rt, cfg, 0, B * S)
    rgap = float((rk.calls[0]["logits"] - rt.calls[0]["logits"]).abs().max())
    log(f"  {KIMI_SERVE_PATH} layer 0: dropped {a['dropped']} of {sum(a['loads'])} (capacity {a['capacity']}), "
        f"smallest router margin {a['margin']:.3e}; planes' router logits within {rgap:.3e}, routing "
        f"{'equal' if (a['loads'], a['dropped']) == (b['loads'], b['dropped']) else b}")
    if a["margin"] > 10 * rgap and (a["loads"], a["dropped"]) != (b["loads"], b["dropped"]):
        raise AssertionError(f"{KIMI_SERVE_PATH}: the planes route differently: {a} vs {b}")
    gap = float((k.logits[0] - t.logits[0]).abs().max())
    if gap > tol:
        raise AssertionError(f"{KIMI_SERVE_PATH}: prefill logits of the planes differ by {gap} > {tol}")
    m = margins(t.logits)
    for r in range(B):
        n = decided_steps(m[:, r].tolist(), tol)
        if k.tokens[r, :n].tolist() != t.tokens[r, :n].tolist():
            raise AssertionError(f"{KIMI_SERVE_PATH}: request {r}: greedy tokens differ within the first {n} steps")
        log(f"  request {r}: tokens equal over the {n} decided steps of {G} "
            f"({int((k.tokens[r] == t.tokens[r]).sum())} equal in all)")
    log(f"{KIMI_SERVE_PATH}: prefill logits of the planes within {gap:.3e} (tolerance {tol}); logits std "
        f"{float(k.logits[0].std()):.3f}; peak {peak:.3f} GB; init {init_s:.3f} s")
    del k, t, rk, rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return got


# the LM training main path: stablelm-1.6b at full width and depth, float32, AdamW, remat "full"
TRAIN = dict(batch=4, seq=2048, steps=5)
TRAIN_PATH = "train/stablelm-1.6b"
# step-0 loss of the training path against a torch-plane forward of the same batch (absolute; the loss
# is about 11.8, where a float32 step is 9.5e-7): the two differ only in summation order (the training
# route's scan-flash attention and chunked loss against naive attention and whole logits)
TRAIN_LOSS_TOL = 1e-4
TRAIN_RUNNER = dict(batch=4, seq=32, steps=14, ckpt_every=5, fail_at=9)  # reduced config, tests/test_substrate.py
# the MoE training path on meshes of shards on the one card: llama4-scout-17b-a16e at full width, depth cut to 1 of
# 48 layers (4.15 B float32 parameters, 16.6 GB), bf16 momentum (an AdamW step's four float32 copies, 66.4 GB, and
# the activations, about 17 GB, do not fit the card), B x S = 2 x 2048, on each (data, model) mesh with every shard
# on the card
MOE_TRAIN = dict(layers=1, batch=2, seq=2048, steps=4, optimizer="momentum_bf16", meshes=("1x1", "1x4", "2x2"))
MOE_TRAIN_PATH = "train/llama4-scout-17b-a16e@"  # + the mesh


# 2-D leaves that no product multiplies: the depthwise conv's taps, the SSM's decay rates
NOT_PRODUCTS = ("conv_w", "A_log")
# a decoder layer's products over the encoder's states, one row per frame
FRAME_PRODUCTS = ("xattn.wk", "xattn.wv")
# operations of the sequential recurrence per state element and token, forward: the SSM's dA and dBx products,
# h's multiply-add and the readout's multiply-add (6); the RG-LRU's h multiply-add (2); as much again recomputed
# under remat and twice that in the backward (x 4)
SSM_SCAN_OPS, RGLRU_SCAN_OPS = 4 * 6, 4 * 2


def train_bound_ms(cfg, params, B, S):
    """The least time of one float32 training step at (B, S) under remat
    "full", and what bounds it.  Operations: 2 flops per weight per row
    for each product (a token's row; a frame's for the encoder's products
    and a decoder's cross k and v), 4 times: the forward, twice that in the
    backward, and the recomputation, but for each block's last product,
    whose output the backward does not need; the head over the S - 1
    positions the loss reads, 4 times (its loss chunks are checkpointed);
    attention 4 Dh flops per (query, key) pair and head forward, 16 Dh in
    all (causal pairs; at most the window's W keys for a local layer; T x T
    in the encoder, S x T across); the SSM's and RG-LRU's recurrence as the
    sequential one (``SSM_SCAN_OPS`` per token, channel and state,
    ``RGLRU_SCAN_OPS`` per token and channel), not the reference's tree of
    products.  Bytes: the parameters, gradients, m and v read once and
    written once (float32).  Returns (ms, "operations" or "bytes", flops)."""
    T = cfg.enc_seq_len
    rows = {"layers": B * S, "dec_layers": B * S, "enc_layers": B * T}
    named = dict(params.named_parameters())
    flops = 0
    for name, p in named.items():
        parts = name.split(".")
        if parts[0] in rows and p.dim() == 2 and parts[-1] not in NOT_PRODUCTS:
            r = B * T if ".".join(parts[-2:]) in FRAME_PRODUCTS else rows[parts[0]]
            flops += 4 * 2 * r * p.numel()
    layer_names = {".".join(n.split(".")[:2]) for n in named if n.split(".")[0] in rows}
    for layer in layer_names:  # the last product of each block is not recomputed
        last = named.get(f"{layer}.mlp.wd", named.get(f"{layer}.ssm.out_proj"))
        flops -= 2 * rows[layer.split(".")[0]] * last.numel()
    head = params.embed if cfg.tie_embeddings else params.lm_head
    flops += 4 * 2 * B * (S - 1) * head.numel()

    def pairs(n, window=0):
        return n * (n + 1) // 2 if not window else sum(min(q + 1, window) for q in range(n))

    att = 16 * cfg.head_dim * B * cfg.n_heads
    if cfg.encoder_decoder:
        flops += att * (cfg.n_enc_layers * T * T + cfg.n_layers * (pairs(S) + S * T))
    else:
        kinds = cfg.layer_kinds()
        flops += att * kinds.count("attn") * pairs(S, cfg.local_window)
        flops += SSM_SCAN_OPS * kinds.count("ssm") * B * S * cfg.d_inner * cfg.ssm_state
        flops += RGLRU_SCAN_OPS * kinds.count("rglru") * B * S * cfg.rnn_width
    n_bytes = 4 * sum(p.numel() for p in named.values()) * 8  # p, g, m, v: each read once and written once
    ms = max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    return ms, ("operations" if flops / FP32_FLOPS_PER_S >= n_bytes / HBM_BYTES_PER_S else "bytes"), flops


def phase_train(counted):
    """The LM training path on the card: the golden-file run (full width,
    depth cut as the file says, 3 AdamW steps) against the JAX reference
    (``train_golden``); the main path at full width and depth (B x S =
    TRAIN, 5 AdamW steps, ``train_main``: none of the counted kernels may
    launch); then a reduced fault-tolerant run with an injected failure
    against the same run without it.  Returns the main path's launches by
    kernel."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.ft.runner import TrainRunner
    from repro_torch.models.lm import init_lm
    from repro_torch.train.golden import GOLDEN_TRAIN
    from repro_torch.train.steps import build_train_step

    train_golden(GOLDEN_TRAIN)
    got, _ = train_main("stablelm-1.6b", counted, dict(layers=None, **TRAIN))

    # (d) the fault-tolerant runner, reduced, with and without an injected failure
    r = TRAIN_RUNNER
    red = reduced_config("stablelm-1.6b")
    step_fn, opt = build_train_step(red, "adamw")

    def init_state():
        p = init_lm(prng.prng_key(0), red, torch.float32, device="cuda")
        return p, opt.init(dict(p.named_parameters()))

    init, nxt = make_pipeline(red.vocab_size, r["batch"], r["seq"], seed=1, device="cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="train_ckpt_")
    try:
        clean = TrainRunner(step_fn, init_state, nxt, init).run(r["steps"], log_every=1000)
        failed = TrainRunner(step_fn, init_state, nxt, init, ckpt_dir=ckpt, ckpt_every=r["ckpt_every"],
                             fail_at=r["fail_at"]).run(r["steps"], log_every=1000)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    f, c = failed["losses"], clean["losses"]
    if f[: r["fail_at"]] != c[: r["fail_at"]] or f[r["fail_at"]:] != c[r["ckpt_every"]:]:
        raise AssertionError(f"train runner: the failure-injected stream {f} differs from the clean {c}")
    log(f"train runner ({red.name} reduced, {r['steps']} steps, failure at {r['fail_at']}, checkpoints every "
        f"{r['ckpt_every']}): losses equal to the run without the failure, bitwise ({c[-1]} last)")
    return got


# the SSM, hybrid and encoder-decoder training main paths: full width, float32, AdamW, the config's remat ("full");
# layers None: the whole model.  falcon-mamba-7b's 64 layers with AdamW need about 116 GB: cut to 16 layers (2.22 B
# parameters, four float32 copies 35.5 GB) for the smoke's time limit; 32 layers fit (four copies: p, g clipped in
# place, m, v, 62.4 GB; peak 72.4 GB, the backward's, ROADMAP.md C.23; with a clipped copy, five, 36 layers ran out of
# memory); recurrentgemma-2b's whole 53.0 GB fit
TRAIN_FAMILIES = {
    "whisper-small": dict(layers=None, batch=8, seq=448, steps=4),
    "recurrentgemma-2b": dict(layers=None, batch=1, seq=4096, steps=4),
    "falcon-mamba-7b": dict(layers=16, batch=1, seq=4096, steps=4),
}
TRAIN_FAMILY_PATH = "train/"  # + the arch
# whisper-small through its training launcher: checkpoints every 3 steps, a failure injected at step 4, which
# restores step 3's checkpoint and replays steps 3 and 4
WHISPER_LAUNCH = dict(batch=8, seq=448, steps=5, ckpt_every=3, fail_at=4)
WHISPER_LAUNCH_PATH = "train/whisper-small launcher"
# the M-RoPE VLM training main path: qwen2-vl-72b at full width, float32, AdamW, remat "full", cut to 1 of 80 layers
# (3.37 B parameters, 13.5 GB; its microbatch of train_4k's 8, each cut from 32 x 4096 to 1 x 2048, 2 of them):
# the step holds five float32 copies of the parameters (p, m, v, the accumulated g and one microbatch's g: 67.4 GB)
# at the second microbatch's backward; with the update's clipped copy and an out-of-place division it would hold
# six, 80.9 GB, more than the card
TRAIN_VLM = dict(layers=1, batch=1, seq=2048, steps=3, micro=2)


def train_golden(path):
    """A training golden file's run on the card (``golden.port_run``): its
    draws bitwise, every gap within the file's tolerance.  Returns the
    gaps."""
    import torch

    from repro_torch.train.golden import draw_mismatches, port_run, rel_gaps

    with open(path) as f:
        golden = json.load(f)
    name = f"train golden {golden['arch']}"
    t0 = time.perf_counter()
    record, draws = port_run(golden, device="cuda")
    bad = draw_mismatches(draws, golden)
    if bad:
        raise AssertionError(f"{name}: the card's draws differ from the reference's: {bad}")
    gaps = rel_gaps(record, golden)
    cut = golden.get("cut") or f"{golden['n_layers']} layers"
    log(f"{name} ({cut}; B={golden['batch']} x S={golden['seq']}, {golden['steps']} {golden['optimizer']} steps, "
        f"{time.perf_counter() - t0:.3f} s): "
        f"losses {record['losses']} (reference {golden['losses']}), grad_norms {record['grad_norms']}; relative "
        f"gaps {gaps}, tolerances {golden['tolerance']} (10x the port's CPU gaps {golden['port_cpu_gap']}); "
        f"{' and '.join(k for k in ('tokens', 'frames_sha256') if k in golden)} bitwise")
    for key, gap in gaps.items():
        if not gap <= golden["tolerance"][key]:
            raise AssertionError(f"{name}: {key} off by {gap} > {golden['tolerance'][key]}")
    del record
    torch.cuda.empty_cache()
    return gaps


def train_main(arch, counted, run):
    """An arch's training main path at full width (``run``: the depth,
    B, S, steps and, optionally, ``micro`` microbatches of B x S a step):
    ``init_lm`` from seed 0, the launcher's batches (``train_batches`` of
    micro x B rows, reshaped to (micro, B, ...) for gradient accumulation),
    step 0's loss from torch-plane forwards (the mean over the
    microbatches), then ``run["steps"]`` AdamW steps of
    ``build_train_step`` with every launch counted from 0 (none may
    launch), timed, their peak memory beside the float32 copies of the
    parameters the step holds, one more step profiled beside its bound.
    Returns (the launches, a summary)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models.lm import init_lm, lm_apply, xent_loss
    from repro_torch.train.steps import build_train_step, train_batches

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)[0]
    cfg = dataclasses.replace(full, n_layers=run["layers"] or full.n_layers)
    cut = f"{cfg.n_layers} of {full.n_layers} layers" if cfg.n_layers < full.n_layers else "whole"
    if cfg.encoder_decoder:
        cut += f" ({cfg.n_enc_layers} encoder layers over {cfg.enc_seq_len} frames)"
    B, S, n, micro = run["batch"], run["seq"], run["steps"], run.get("micro", 1)
    path = TRAIN_FAMILY_PATH + arch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    init, nxt = train_batches(cfg, micro * B, S, seed=0, device="cuda")
    batches, ds = [], init()
    for _ in range(n + 1):
        ds, b = nxt(ds)
        if micro > 1:  # (micro x B, ...) rows -> (micro, B, ...): microbatch i holds rows i B .. (i + 1) B - 1
            b = {k: v.reshape(micro, B, *v.shape[1:]) for k, v in b.items()}
        batches.append(b)
    with torch.inference_mode():  # step 0's loss from torch-plane forwards of the same batch and weights
        mbs = [batches[0]] if micro == 1 else [{k: v[i] for k, v in batches[0].items()} for i in range(micro)]
        mb_losses = []
        for mb in mbs:
            logits = lm_apply(params, cfg, {k: v for k, v in mb.items() if k != "labels"}, plane="torch")
            mb_losses.append(float(xent_loss(logits[:, :-1], mb["labels"][:, 1:])))
            del logits
        ref_loss = sum(mb_losses) / micro
    step_fn, opt = build_train_step(cfg, "adamw")
    state = opt.init(dict(params.named_parameters()))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    step_ms, losses, gnorms = [], [], []
    for step in range(n):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, step, batches[step])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    got = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    _, p_wall, p_busy, p_ops, p_top, _ = device_busy(lambda: step_fn(params, state, n, batches[n]), cpu=False)
    profile_s = time.perf_counter() - t0
    bound, bound_by, flops = train_bound_ms(cfg, params, micro * B, S)
    ms = sum(step_ms[1:]) / (n - 1)
    # float32 copies of the parameters a step holds besides activations: p, m, v and the gradients (clipped in place);
    # under accumulation the sum beside one microbatch's gradients
    copies = 4 + (micro > 1)
    res = {"cut": cut, "n_params": n_params, "init_s": init_s, "ms_per_step": ms, "step_ms": step_ms,
           "micro": micro, "tokens_per_s": micro * B * S / ms * 1e3, "peak_gb": peak, "copies": copies,
           "copies_gb": 4 * copies * n_params / 1e9,
           "step_wall_ms": p_wall, "step_device_busy_ms": p_busy, "step_idle_share": 1 - p_busy / p_wall,
           "step_device_ops": p_ops, "bound_ms": bound, "bound_by": bound_by, "flops": flops,
           "step_over_bound": ms / bound, "losses": losses, "grad_norms": gnorms, "ref_loss": ref_loss,
           "profile_s": profile_s, "top_launches_and_ms": p_top, "microbatch_ref_losses": mb_losses}
    shape = f"B={B} x S={S}" if micro == 1 else f"{micro} microbatches of B={B} x S={S}"
    log(f"main path {path} ({cut}, {n_params:,} parameters, {shape}, AdamW, float32, remat {cfg.remat}): "
        f"{ms:.3f} ms/step over steps 1-{n - 1} (step 0 {step_ms[0]:.3f}), {micro * B * S / ms * 1e3:.1f} tokens/s, "
        f"peak {peak:.3f} GB allocated ({copies} float32 copies of the parameters held {res['copies_gb']:.3f}: p, m, "
        f"v, g{', one microbatch g' if micro > 1 else ''}), profiled step: "
        f"busy {p_busy:.3f} of {p_wall:.3f} ms, idle {1 - p_busy / p_wall:.4f}, {p_ops} device operations; bound "
        f"{bound:.3f} ms by {bound_by} ({flops / 1e12:.2f} TFLOP), the step {ms / bound:.2f}x it; init "
        f"{init_s:.3f} s; losses {losses}, grad_norms {gnorms}, launches {got}")
    log(f"train family profile {arch}: " + json.dumps(res))
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{path}: a loss or grad_norm is not finite")
    if abs(losses[0] - ref_loss) > TRAIN_LOSS_TOL:
        raise AssertionError(f"{path}: step-0 loss {losses[0]} vs torch-plane forward {ref_loss}")
    log(f"{path}: step-0 loss {losses[0]} within {abs(losses[0] - ref_loss):.3e} of the torch-plane "
        f"forward{'s' if micro > 1 else ''}' {ref_loss}{f' (mean of {mb_losses})' if micro > 1 else ''} "
        f"(tolerance {TRAIN_LOSS_TOL})")
    if any(got.values()):
        raise AssertionError(f"{path}: launched {got}; the training route runs no hand-written kernel")
    del params, state, batches, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return got, res


def train_whisper_launcher(counted):
    """whisper-small through its training launcher (``repro_torch.launch.
    train.main``) at WHISPER_LAUNCH's batch, twice: without checkpoints,
    then with checkpoints under ``build/`` and a failure injected between
    two of them; the second run's losses must be the first's, bitwise, as
    the restore replays the steps since the checkpoint.  Returns the two
    runs' launches (none may launch)."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as launch_train

    r = WHISPER_LAUNCH
    argv = ["--arch", WHISPER_ARCH, "--batch", str(r["batch"]), "--seq", str(r["seq"]), "--steps", str(r["steps"]),
            "--device", "cuda"]
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    clean = launch_train.main(argv)["losses"]
    clean_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="train_whisper_ckpt_")
    try:
        t0 = time.perf_counter()
        failed = launch_train.main(argv + ["--ckpt", ckpt, "--ckpt-every", str(r["ckpt_every"]),
                                           "--fail-at", str(r["fail_at"])])["losses"]
        failed_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    got = {fn.__name__: fn.launches for fn in counted}
    gc.collect()
    torch.cuda.empty_cache()
    F, K = r["fail_at"], r["ckpt_every"] * (r["fail_at"] // r["ckpt_every"])
    if failed[:F] != clean[:F] or failed[F:] != clean[K:]:
        raise AssertionError(f"{WHISPER_LAUNCH_PATH}: the failure-injected losses {failed} differ from the clean "
                             f"run's {clean}")
    log(f"{WHISPER_LAUNCH_PATH} (python -m repro_torch.launch.train {' '.join(argv)}): clean {clean_s:.3f} s, "
        f"losses {clean}; with --ckpt-every {r['ckpt_every']} --fail-at {F} {failed_s:.3f} s, losses {failed}: "
        f"steps {K}-{F - 1} replayed from step {K}'s checkpoint, every loss equal to the clean run's, bitwise; "
        f"launches {got}")
    if any(got.values()):
        raise AssertionError(f"{WHISPER_LAUNCH_PATH}: launched {got}; the training route runs no hand-written kernel")
    return got


def phase_train_families(counted):
    """The SSM, hybrid and encoder-decoder training paths on the card: for
    each of TRAIN_FAMILIES, its golden file (``train_golden``) and its main
    path (``train_main``); then whisper-small through its
    launcher with and without an injected failure
    (``train_whisper_launcher``).  Returns each path's launches."""
    from repro_torch.train.golden import GOLDEN_TRAIN_FAMILIES

    got_by_path, summary = {}, {}
    for arch, run in TRAIN_FAMILIES.items():
        t0 = time.perf_counter()
        gaps = train_golden(GOLDEN_TRAIN_FAMILIES[arch])
        golden_s = time.perf_counter() - t0
        got, res = train_main(arch, counted, run)
        got_by_path[TRAIN_FAMILY_PATH + arch] = got
        keys = ("cut", "ms_per_step", "tokens_per_s", "peak_gb", "step_idle_share", "step_device_ops", "bound_ms",
                "bound_by", "step_over_bound", "profile_s")
        summary[arch] = {"golden_gaps": gaps, "golden_s": golden_s, "main_s": time.perf_counter() - t0 - golden_s,
                         **{k: res[k] for k in keys}}
    t0 = time.perf_counter()
    got_by_path[WHISPER_LAUNCH_PATH] = train_whisper_launcher(counted)
    summary["launcher_s"] = time.perf_counter() - t0
    log("train families: " + json.dumps(summary))
    return got_by_path


def phase_train_vlm(counted):
    """The M-RoPE VLM training path on the card: qwen2-vl-72b at full
    width, TRAIN_VLM's layers, ``init_lm`` from seed 0; (a) the golden
    file's gradient of ``lm_loss`` on its request, whose image grid gives
    the three position ids distinct values (loss, gradient norm and every
    leaf's sums within its tolerances, each gap printed beside its
    tolerance); (b) the accumulation path: ``train_main`` at TRAIN_VLM's
    microbatches, launches counted from 0 (none: the training route runs no
    hand-written kernel).  Returns the main path's launches by kernel."""
    import gc

    import torch

    from repro_torch.core import prng
    from repro_torch.models.lm import init_lm
    from repro_torch.train import golden as tg

    gc.collect()
    torch.cuda.empty_cache()
    with open(tg.GOLDEN_TRAIN_VLM) as f:
        golden = json.load(f)
    cfg = tg.file_config(golden)
    if cfg.n_layers != TRAIN_VLM["layers"]:
        raise AssertionError(f"{tg.GOLDEN_TRAIN_VLM} holds {cfg.n_layers} layers, the phase {TRAIN_VLM['layers']}")
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(golden["seed"]), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = tg.vlm_batch(golden, "cuda")
    if batch["tokens"].tolist() != golden["tokens"] or batch["positions"].tolist() != golden["positions"]:
        raise AssertionError("train vlm golden: the card's tokens or positions differ from the reference's")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec, _ = tg.grad_record(params, cfg, batch)
    grad_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    gaps, tol = tg.grad_gaps(rec, golden, cfg), golden["tolerance"]
    log(f"train vlm golden ({cfg.name}, {golden['cut'].split(':')[0]}, B={golden['batch']} x S={golden['seq']}, image "
        f"{golden['image']}; init {init_s:.3f} s, value_and_grad and leaf sums {grad_s:.3f} s, peak {peak:.3f} GB): "
        f"loss {rec['loss']} (reference {golden['loss']}), grad_norm {rec['grad_norm']} (reference "
        f"{golden['grad_norm']}); tokens and positions bitwise")
    for key, gap in gaps.items():
        log(f"  train vlm golden {key}: relative gap {gap:.3e}, tolerance {tol[key]:.3e} (10x the port's CPU gap "
            f"{golden['port_cpu_gap'][key]:.3e}, no tighter than 1e-6)")
    for key, gap in gaps.items():
        if not gap <= tol[key]:
            raise AssertionError(f"train vlm golden: {key} off by {gap} > {tol[key]}")
    del params, batch, rec
    gc.collect()
    torch.cuda.empty_cache()
    got, res = train_main(VLM_ARCH, counted, TRAIN_VLM)
    log("train vlm: " + json.dumps({"golden_gaps": gaps, "golden_s": grad_s, "golden_peak_gb": peak,
                                    **{k: res[k] for k in ("cut", "micro", "ms_per_step", "tokens_per_s", "peak_gb",
                                                           "copies_gb", "step_device_busy_ms", "step_idle_share",
                                                           "step_device_ops", "bound_ms", "bound_by",
                                                           "step_over_bound")}}))
    return got


def phase_train_moe_mesh(counted):
    """The MoE training path on meshes of shards on the one card:
    llama4-scout at full width, MOE_TRAIN's layers, init_lm from seed 0;
    the mesh golden file's gradient of lm_loss on each of its meshes (loss,
    gradient norm and leaf sums within its tolerances, each data shard's
    routing held where the reference's margin allows); then on each mesh
    build_train_step(cfg, "momentum_bf16", shd=...) for MOE_TRAIN's steps,
    launches counted from 0 (none: the training route runs no hand-written
    kernel), ms per step, tokens/s, peak memory beside the reckoning of
    parameters, gradients (clipped in place) and momentum, and one step
    profiled, each beside the (1, 1) mesh's.  The meshes train the same
    parameters in turn.  Returns each mesh path's launches by kernel."""
    import gc

    import torch

    from repro_torch.core import prng
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models.lm import init_lm
    from repro_torch.train import golden as tg
    from repro_torch.train.steps import build_train_step

    gc.collect()
    torch.cuda.empty_cache()
    with open(tg.GOLDEN_TRAIN_MESH) as f:
        golden = json.load(f)
    cfg = tg.file_config(golden)
    if cfg.n_layers != MOE_TRAIN["layers"]:
        raise AssertionError(f"{tg.GOLDEN_TRAIN_MESH} holds {cfg.n_layers} layers, the phase {MOE_TRAIN['layers']}")
    tol, router_gap = golden["tolerance"], golden["port_cpu_gap"]["router_logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_lm(prng.prng_key(golden["seed"]), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"train moe mesh: init_lm({cfg.name}, {cfg.n_layers} of 48 layers, seed {golden['seed']}) on the card: "
        f"{n_params:,} parameters in {time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"init_lm: {n_params} parameters, config {cfg.param_count()} + the final norm")

    # (a) the golden file: one value_and_grad of lm_loss on each of its meshes
    tokens = tg.mesh_tokens(golden, "cuda")
    if tokens.tolist() != golden["tokens"]:
        raise AssertionError("train moe mesh golden: the card's tokens differ from the reference's")
    for mesh, want in golden["meshes"].items():
        t0 = time.perf_counter()
        rec, _ = tg.grad_record(params, cfg, {"tokens": tokens, "labels": tokens}, tg.mesh_rules(golden, mesh, "cuda"))
        gaps = tg.grad_gaps(rec, want, cfg)
        log(f"train moe mesh golden {mesh} (B={golden['batch']} x S={golden['seq']}, {time.perf_counter() - t0:.3f} "
            f"s): loss {rec['loss']} (reference {want['loss']}), grad_norm {rec['grad_norm']} (reference "
            f"{want['grad_norm']}); relative gaps {gaps}, tolerances {tol}")
        for key, gap in gaps.items():
            if not gap <= tol[key]:
                raise AssertionError(f"train moe mesh golden {mesh}: {key} off by {gap} > {tol[key]}")
        for c in tg.routing_checks(rec["routing"], want["routing"], router_gap):
            log(f"  golden routing {mesh}, layer {c['layer']}, data shard {c['shard']}: dropped "
                f"{c['got']['dropped']} of {sum(c['got']['loads'])} (reference {c['want']['dropped']}), capacity "
                f"{c['got']['capacity']}, loads {'equal' if c['got']['loads'] == c['want']['loads'] else c['got']['loads']}"
                + ("" if c["held"] else f": not held (reference margin {c['want']['margin']:.3e} <= 10x {router_gap:.3e})"))
            if c["held"] and not c["equal"]:
                raise AssertionError(f"train moe mesh golden {mesh}: layer {c['layer']} shard {c['shard']} routes "
                                     f"{c['got']} where the reference routes {c['want']}")

    # (b) the main path on each mesh: MOE_TRAIN's steps of build_train_step, one more profiled
    B, S, n = MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE_TRAIN["steps"]
    init, nxt = make_pipeline(cfg.vocab_size, B, S, seed=0, device="cuda")
    batches, ds = [], init()
    for _ in range(n + 1):
        ds, b = nxt(ds)
        batches.append(b)
    # what a step holds besides its activations: parameters and gradients (float32, clipped in place), momentum (bf16)
    reckoned = n_params * (4 + 4 + 2) / 1e9
    got_by_path, res = {}, {}
    for mesh in MOE_TRAIN["meshes"]:
        shd = tg.mesh_rules(golden, mesh, "cuda")
        step_fn, opt = build_train_step(cfg, MOE_TRAIN["optimizer"], shd=shd)
        state = opt.init(dict(params.named_parameters()))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        step_ms, losses, gnorms = [], [], []
        for step in range(n):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, step, batches[step])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {fn.__name__: fn.launches for fn in counted}
        peak = torch.cuda.max_memory_allocated() / 1e9
        _, p_wall, p_busy, p_ops, p_top, _ = device_busy(lambda: step_fn(params, state, n, batches[n]))
        ms = sum(step_ms[1:]) / (n - 1)
        res[mesh] = {"ms_per_step": ms, "tokens_per_s": B * S / ms * 1e3, "peak_gb": peak, "step_ms": step_ms,
                     "losses": losses, "grad_norms": gnorms, "step_wall_ms": p_wall, "step_device_busy_ms": p_busy,
                     "step_idle_share": 1 - p_busy / p_wall, "step_device_ops": p_ops, "top_launches_and_ms": p_top}
        base = res[MOE_TRAIN["meshes"][0]]
        log(f"main path {MOE_TRAIN_PATH}{mesh} ({cfg.n_layers} layer, B={B} x S={S}, {MOE_TRAIN['optimizer']}, "
            f"float32, remat {cfg.remat}): {ms:.3f} ms/step over steps 1-{n - 1} (step 0 {step_ms[0]:.3f}; "
            f"{MOE_TRAIN['meshes'][0]}: {base['ms_per_step']:.3f}), {B * S / ms * 1e3:.1f} tokens/s, peak "
            f"{peak:.3f} GB allocated ({MOE_TRAIN['meshes'][0]}: {base['peak_gb']:.3f}; parameters, gradients "
            f"and momentum reckoned {reckoned:.3f}), profiled step: busy {p_busy:.3f} of "
            f"{p_wall:.3f} ms, idle {1 - p_busy / p_wall:.4f}, {p_ops} device operations ({MOE_TRAIN['meshes'][0]}: "
            f"busy {base['step_device_busy_ms']:.3f} of {base['step_wall_ms']:.3f}, {base['step_device_ops']}); "
            f"losses {losses}, grad_norms {gnorms}, launches {got}")
        if not all(map(math.isfinite, losses + gnorms)):
            raise AssertionError(f"{MOE_TRAIN_PATH}{mesh}: a loss or grad_norm is not finite")
        if any(got.values()):
            raise AssertionError(f"{MOE_TRAIN_PATH}{mesh}: launched {got}; the training route runs no hand-written "
                                 "kernel")
        got_by_path[MOE_TRAIN_PATH + mesh] = got
        del step_fn, opt, state
    log("train moe mesh profile: " + json.dumps(res))
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return got_by_path


def main_path_spec(protocol, workload, plane, codes=CODES):
    from repro_torch.api import ExperimentSpec

    return ExperimentSpec(
        protocol=protocol, workload=workload, configs=[{"hybrid": c} for c in codes], kernel_plane=plane
    )


def show_rows(label, rows, warmup, every=True):
    """Each row's counters (or, with ``every`` False, the first four) and
    its bucket's simulated ticks (``warmup`` + its own) per wall second;
    fails on a metric that is not finite."""
    for i, r in enumerate(rows):
        ticks = r["ticks"] + warmup
        if every or i < 4:
            log(f"  {label} hybrid={r['hybrid']} commits={r['commits']} aborts={r['aborts']} "
                f"throughput_mtps={r['throughput_mtps']} avg_latency_us={r['avg_latency_us']} "
                f"bucket wall_s={r['wall_s']:.3f} sim_ticks_per_s={ticks / r['wall_s']:.1f}")
        for k in ("throughput_mtps", "avg_latency_us", "abort_rate", "avg_round_trips"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{label} {r['hybrid']}: {k}={r[k]} is not finite")
        if len(r["stage_us_per_commit"]) != 8 or not all(map(math.isfinite, r["stage_us_per_commit"])):
            raise AssertionError(f"{label} {r['hybrid']}: bad stage_us_per_commit")


def counted_run(spec, counted):
    """``api.run(spec)`` with every kernel's launch count set to 0 just
    before and read just after: (results, launches by kernel)."""
    from repro_torch import api

    for fn in counted:
        fn.launches = 0
    res = api.run(spec)
    return res, {fn.__name__: fn.launches for fn in counted}


def check_launches(path, protocol, res, got):
    """A batched RCC path launches each kernel PER_TICK times per tick,
    whatever its config count."""
    gs = res.plan.buckets[0].grid_spec
    n_ticks = gs.ticks + gs.warmup
    expect = {name: per * n_ticks for name, per in PER_TICK[protocol].items()}
    if len(res.plan.buckets) != 1 or got != expect:
        raise AssertionError(f"{path}: {len(res.plan.buckets)} bucket(s), kernel launches {got} != {expect}")
    return n_ticks


def golden_counters(path, res, golden_file):
    with open(os.path.join(ROOT, "src", "repro_torch", "data", golden_file)) as f:
        golden = json.load(f)
    want = {r["hybrid"]: r for r in golden["rows"]}
    rows = [{"hybrid": r["hybrid"], "commits": r["commits"], "aborts": r["aborts"]} for r in res.rows]
    if [want[r["hybrid"]] for r in rows] != rows:
        raise AssertionError(f"{path}: counters {rows} != JAX golden {golden['rows']}")
    log(f"{path} golden: counters of {len(rows)} configs equal the JAX reference's ({golden_file})")
    return golden


def phase_sweep(counted):
    """NOWAIT/SmallBank's 64 hybrid codes as ONE bucket on the kernel plane
    at the full spec: launches per tick as for any batch, rows against the
    JAX reference's vmapped 64-code grid."""
    spec = main_path_spec("nowait", "smallbank", "kernel", tuple(range(64)))
    res, got = counted_run(spec, counted)
    n_ticks = check_launches(SWEEP_PATH, "nowait", res, got)
    log(f"main path {SWEEP_PATH} (kernel plane, 64 configs in one bucket): {res.wall_s:.3f} s for {n_ticks} "
        f"batched ticks, {64 / res.wall_s:.3f} configs/s, launches {got}")
    show_rows(SWEEP_PATH, res.rows, res.plan.spec.warmup, every=False)
    golden = golden_counters(SWEEP_PATH, res, "golden_nowait_smallbank_sweep64.json")
    if golden["spec"] != {"protocol": "nowait", "workload": "smallbank", "configs": [{"hybrid": c} for c in range(64)]}:
        raise AssertionError(f"golden_nowait_smallbank_sweep64.json holds another spec: {golden['spec']}")
    return res, got


def phase_calvin(counted):
    """CALVIN at the full spec on the kernel plane: smallbank, ycsb and tpcc,
    each ONE bucket of CODES, against golden_calvin.json (commits, aborts and
    the round and wave averages exactly, the float32 epoch-sum metrics to
    rtol 1e-5); CALVIN reaches no RCC kernel.  Then a profiled run of
    smallbank's batched epochs."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.core.protocols import calvin
    from repro_torch.core.sweep import GridSpec, engine_config, make_knobs

    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_calvin.json")) as f:
        golden = json.load(f)
    total = {fn.__name__: 0 for fn in counted}
    for cell in golden["cells"]:
        spec = cell["spec"]
        if spec["protocol"] != "calvin" or spec["configs"] != [{"hybrid": c} for c in CODES]:
            raise AssertionError(f"golden_calvin.json holds another spec: {spec}")
        res, got = counted_run(ExperimentSpec(**spec, kernel_plane="kernel"), counted)
        n_epochs = calvin.epochs_for_ticks(res.plan.buckets[0].grid_spec.ticks)
        log(f"main path {CALVIN_PATH}/{spec['workload']} (kernel plane, {len(CODES)} configs in one bucket): "
            f"{res.wall_s:.3f} s for {n_epochs} batched epochs, {res.wall_s / n_epochs * 1e3:.3f} ms per epoch, "
            f"{len(CODES) / res.wall_s:.3f} configs/s, launches {got}")
        if len(res.plan.buckets) != 1 or any(got.values()):
            raise AssertionError(f"{CALVIN_PATH}/{spec['workload']}: one bucket, no RCC kernel launch expected: {got}")
        total = {name: total[name] + n for name, n in got.items()}
        for a, b in zip(res.rows, cell["rows"]):
            log(f"  calvin/{spec['workload']} hybrid={a['hybrid']} commits={a['commits']} avg_waves={a['avg_waves']} "
                f"avg_round_trips={a['avg_round_trips']} throughput_mtps={a['throughput_mtps']}")
            for k in ("hybrid", "commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves"):
                if a[k] != b[k]:
                    raise AssertionError(f"calvin/{spec['workload']} {a['hybrid']}: {k} {a[k]} != golden {b[k]}")
            for k in ("throughput_mtps", "avg_latency_us"):
                if not math.isclose(a[k], b[k], rel_tol=1e-5):
                    raise AssertionError(f"calvin/{spec['workload']} {a['hybrid']}: {k} {a[k]} vs golden {b[k]}")
        log(f"calvin/{spec['workload']} golden: rows equal the JAX reference's (golden_calvin.json)")

    # where a batched epoch's time goes
    gs = GridSpec(protocol="calvin", workload="smallbank", kernel_plane="kernel", device="cuda")
    ec, cm, wl = engine_config(gs, make_knobs("smallbank", [{"hybrid": c} for c in CODES]))
    n_epochs = 4
    _, wall, busy, n_ops, top, _ = device_busy(lambda: calvin.run_epochs(ec, cm, wl, n_epochs))
    log("calvin profile: " + json.dumps({
        "path": "calvin/smallbank", "configs": len(CODES), "epoch_wall_ms": wall / n_epochs,
        "device_busy_ms_per_epoch": busy / n_epochs, "device_idle_share": 1 - busy / wall,
        "device_ops_per_epoch": n_ops / n_epochs, "top_launches_and_ms": top}))
    return total


def node_config(G, protocol="nowait"):
    """A paper-scale EngineConfig of G configs on the node mesh (kernel plane)."""
    from repro_torch.core.engine import EngineConfig, node_mesh_config

    ec = EngineConfig(protocol=protocol, n_nodes=4, coroutines=60, records_per_node=65536, n_configs=G,
                      kernel_plane="kernel", device="cuda")
    return node_mesh_config(ec, NODE_DEVICES)


def split_rows(ec, arr):
    """A dense (G*R, ...) store array as the node shards' (G*R_l, ...) arrays."""
    from repro_torch.core.planes import Shards

    G, tail = ec.n_configs, tuple(arr.shape[1:])
    v = arr.view((G, NODE_SHARDS, ec.records_local) + tail)
    return Shards(v[:, s].reshape((G * ec.records_local,) + tail).contiguous() for s in range(NODE_SHARDS))


def node_keys(G, N, K, gen):
    """(G*N, K) global store rows of G configs: random, with every shard's
    first and last rows of each config among them."""
    import torch

    keys = torch.randint(0, R_RECORDS, (G, N, K), generator=gen, dtype=torch.int32)
    edges = torch.tensor([b for s in range(NODE_SHARDS) for b in (s * R_LOCAL, (s + 1) * R_LOCAL - 1)],
                         dtype=torch.int32)
    keys.view(G, -1)[:, :len(edges)] = edges
    return (keys + torch.arange(G, dtype=torch.int32)[:, None, None] * R_RECORDS).view(G * N, K).cuda()


def phase_shard_kernels(gen, rows):
    """The three RCC kernels at the node layout's calls, each against its
    plain version exactly: ``lock_arbiter`` as the node paths' coordinator
    calls it (G groups over the G*R global rows, requests on the rows
    either side of a shard boundary), equal to the node engine's
    ``arb_winner``; ``multi_read`` on each shard's own arrays with local
    keys outside [0, R_l) (the drop form and, at G = 1, the unclipped
    ``key - s*R_l``), the shards' sum equal to the dense gather;
    ``mvcc_version_select`` on the rows that exchange combines, equal to
    the dense fused read.  Then each timed at the node paths' shapes; the
    rows go into ``rows``' ``by_path``."""
    import torch

    from repro_torch.core import engine, planes
    from repro_torch.kernels import ops
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.ref import gather_many_ref, mvcc_version_select_ref, version_read_ref

    by_name = {r["name"]: r for r in rows}
    boundary = torch.tensor([s * R_LOCAL + d for s in range(NODE_SHARDS) for d in (-1, 0, 1)][1:], dtype=torch.int32)
    checked = 0
    for G, M, n_keys, ties, edge in [(1, 480, R_RECORDS, False, False), (1, 2400, R_RECORDS, False, False),
                                     (4, 480, R_RECORDS, True, False), (4, 2400, R_RECORDS, False, False),
                                     (1, 2400, 0, True, True), (4, 480, 0, False, True), (2, 12000, R_RECORDS, True, False)]:
        ec = node_config(G)
        args = arbiter_case(G, M, max(n_keys, 1), gen, ties=ties, rows=R_RECORDS)
        if edge:  # every request on the rows either side of a shard boundary
            pick = boundary[torch.randint(0, len(boundary), (G, M), generator=gen)].cuda()
            args[0] = pick + (torch.arange(G, dtype=torch.int32)[:, None] * R_RECORDS).cuda()
        want = arbiter_ref(args)
        got = lock_arbiter(*args)
        node = engine.arb_winner(ec, *(a.reshape(-1) for a in args))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"lock_arbiter disagrees with its plain version at G={G} M={M} edge={edge}")
        if not torch.equal(node, want.reshape(-1)):
            raise AssertionError(f"arb_winner on the node mesh differs from the plain winners at G={G} M={M}")
        checked += 1
    log(f"  lock_arbiter on the node mesh: {checked} batches (G groups over G*R global rows, rows at the shard "
        f"boundaries): exact, and the node engine's arb_winner gives the same winners")

    for G, N, K, shapes in [(1, 240, 2, ((), ())), (1, 240, 2, ((2,), ())), (1, 240, 10, ((4,), (4,), ())),
                            (4, 240, 10, ((), ())), (4, 240, 2, ((2,), ())), (64, 240, 2, ((), ()))]:
        ec = node_config(G)
        glob = [torch.randint(-2**31, 2**31 - 1, (G * R_RECORDS,) + sh, generator=gen, dtype=torch.int32).cuda()
                for sh in shapes]
        parts = [split_rows(ec, a) for a in glob]
        keys = node_keys(G, N, K, gen)
        kf = keys.reshape(-1)
        owner, local = planes.owner_local(ec, kf)
        for s in range(NODE_SHARDS):
            mine = [p[s] for p in parts]
            forms = [planes.local_ix_drop(ec, s, owner, local)]
            if G == 1:
                forms.append(kf - s * R_LOCAL)  # unclipped: keys outside [0, R_l) read zero rows
            outs = [ops.gather_many(mine, li, plane=ops.KERNEL) for li in forms]
            for li, got in zip(forms, outs):
                if not all(torch.equal(g, w) for g, w in zip(got, gather_many_ref(mine, li))):
                    raise AssertionError(f"multi_read disagrees with its plain version at shard {s}, G={G}")
            if G == 1 and not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError("multi_read: the unclipped local keys read other rows than the drop form")
        got = planes.node_read_batch(ec, parts, keys)
        want = gather_many_ref(glob, kf)
        if not all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want)):
            raise AssertionError(f"multi_read: the shards' summed gathers differ from the dense gather at G={G}")
    log("  multi_read per shard: 6 array sets at G in {1, 4, 64}, drop-form and unclipped local keys: exact, "
        "the summed replies equal the dense gather")

    for G, kind in [(1, "engine"), (4, "engine"), (1, "narrow")]:
        ec = node_config(G, "mvcc")
        N, K, S = G * 240, 10, 4
        wh, wl, lh, ll, _, ch, cl = read_case(G * R_RECORDS, N, K, S, gen, kind)
        keys = node_keys(G, 240, K, gen)
        vh, vl = planes.node_read_batch(ec, (split_rows(ec, wh), split_rows(ec, wl)), keys)
        gh, gl = planes.node_read_batch(ec, (split_rows(ec, lh), split_rows(ec, ll)), keys)
        got = ops.version_select(vh.reshape(-1, S), vl.reshape(-1, S), ch, cl, gh.reshape(-1), gl.reshape(-1))
        want = mvcc_version_select_ref(vh.reshape(-1, S), vl.reshape(-1, S), ch.repeat_interleave(K),
                                       cl.repeat_interleave(K), gh.reshape(-1), gl.reshape(-1))
        dense = version_read_ref(wh, wl, keys, ch, cl, lh, ll)
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or \
                not all(torch.equal(a, b.reshape(-1)) for a, b in zip(got, dense[:3])):
            raise AssertionError(f"mvcc_version_select on the combined rows disagrees at G={G} {kind}")
    log("  mvcc_version_select on the exchanged rows (G = 1, 4): exact, equal to the dense fused read")

    # times at the node paths' calls (multi_read: shard 0's), as the kernel phase times the dense paths'
    for path, (G, N, K) in NODE_SHAPES.items():
        ec = node_config(G)
        M = G * N * K
        args = arbiter_case(G, M, R_RECORDS, gen, rows=R_RECORDS)
        t = timed(lambda: lock_arbiter(*args), lambda: arbiter_ref(args))
        t["bound_ms"], t["bound_by"] = bound_ms(G * M * 14, 0)
        log(f"lock_arbiter ({path}, on the coordinator: G={G}, M={M}, {int(args[3].sum())} active): {t['ms']:.6f} ms/call "
            f"on the device ({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ms "
            f"({t['plain_host_ms']:.6f}), bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
        by_name["lock_arbiter"]["by_path"][path] = dict(t, G=G, M=M)

        keys = node_keys(G, N, K, gen)
        owner, local = planes.owner_local(ec, keys.reshape(-1))
        li = planes.local_ix_drop(ec, 0, owner, local)
        parts = []
        for name, (shapes, n) in NODE_GATHERS[path].items():
            arrs = [torch.randint(0, 1000, (G * R_LOCAL,) + sh, generator=gen, dtype=torch.int32).cuda()
                    for sh in shapes]
            fn = lambda: ops.gather_many(arrs, li, plane=ops.KERNEL)  # noqa: E731
            one_device_op(fn, "multi_read", f"gather_many {path} {name}")
            # no library call reads zero rows for the other shards' keys
            t = timed(fn, lambda: gather_many_ref(arrs, li))
            words = sum(math.prod(sh) for sh in shapes)
            t["bound_ms"], t["bound_by"] = bound_ms(M * 4 + 2 * M * words * 4, 0)
            log(f"multi_read ({path}: {name}, one shard's {G * R_LOCAL} rows, M={M}, {n} per shard per tick): "
                f"{t['ms']:.6f} ms/call on the device ({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} "
                f"({t['plain_host_ms']:.6f}), no library call, bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
            parts.append((n, t))
        by_name["multi_read"]["by_path"][path] = dict(mix(parts), G=G, M=M)

    G, N, K, S = 1, 240, 10, 4
    M = N * K
    wh, wl, lh, ll, _, ch, cl = read_case(M, N, K, S, gen, "engine")  # one op's rows each, as combined
    gh, gl = lh.contiguous(), ll.contiguous()
    parts = []
    for with_lock, n in ((True, 2), (False, 1)):
        lock = (gh, gl) if with_lock else (None, None)
        fn = lambda: ops.version_select(wh, wl, ch, cl, *lock)  # noqa: E731
        one_device_op(fn, "mvcc_version_select", f"version_select {NODE_MVCC} lock={with_lock}")
        z = torch.zeros_like(gh)
        plain = lambda: mvcc_version_select_ref(wh, wl, ch.repeat_interleave(K), cl.repeat_interleave(K),  # noqa: E731
                                                *(lock if with_lock else (z, z)))
        t = timed(fn, plain)
        n_in = M * 2 * S * 4 + N * 8 + (M * 8 if with_lock else 0)
        t["bound_ms"], t["bound_by"] = bound_ms(n_in + M * (1 + 4 + (1 if with_lock else 0)), M * (12 * S + 6))
        log(f"mvcc_version_select ({NODE_MVCC}: on the combined rows, M={M}, S={S}, "
            f"{'with' if with_lock else 'without'} the lock, {n} per tick): {t['ms']:.6f} ms/call on the device "
            f"({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ({t['plain_host_ms']:.6f}), no "
            f"library call, bound {t['bound_ms']:.9f} ms ({t['bound_by']})")
        parts.append((n, t))
    by_name["mvcc_version_select"]["by_path"][NODE_MVCC] = dict(mix(parts), G=G, M=M, S=S)


def node_row_check(path, row, want, exact, close=()):
    """A node-layout row against a golden row: ``exact`` keys equal,
    ``close`` keys within rtol 1e-5; fails on a metric that is not finite."""
    for k in ("throughput_mtps", "avg_latency_us", "abort_rate", "avg_round_trips"):
        if not math.isfinite(row[k]):
            raise AssertionError(f"{path}: {k}={row[k]} is not finite")
    for k in exact:
        if row[k] != want[k]:
            raise AssertionError(f"{path}: {k} {row[k]} != golden {want[k]}")
    for k in close:
        if not math.isclose(row[k], want[k], rel_tol=1e-5):
            raise AssertionError(f"{path}: {k} {row[k]} vs golden {want[k]}")


def phase_node(counted):
    """The node-sharded layouts at paper scale on the kernel plane, four
    node shards on the one card: NOWAIT/SmallBank and MVCC/YCSB hybrid 63
    and CALVIN/SmallBank hybrid 63 (``layout="node"``), and the four codes
    on a 2 x 2 ``config_node`` mesh, each against its golden file, with
    launches per tick counted from 0; then the NOWAIT path's own final
    store (kept from its ``engine.run_sharded``) against a dense
    ``engine.run`` of the same config and ticks.  Returns the launches by
    path and the wall s by path."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.core import engine
    from repro_torch.core.protocols import calvin

    def load(name):
        with open(os.path.join(ROOT, "src", "repro_torch", "data", name)) as f:
            return json.load(f)

    launches, walls = {}, {}
    run_sharded, kept = engine.run_sharded, []

    def keep_store(tick, ec, cm, wl, n_ticks, warmup=0, **kw):
        out = run_sharded(tick, ec, cm, wl, n_ticks, warmup=warmup, **kw)
        kept.append(((tick, ec, cm, wl, n_ticks, warmup), out[1], out[2]))
        return out

    for path, protocol, workload, golden_file in ((NODE_NOWAIT, "nowait", "smallbank",
                                                   "golden_nowait_smallbank_sweep64.json"),
                                                  (NODE_MVCC, "mvcc", "ycsb", "golden_mvcc_ycsb.json")):
        spec = ExperimentSpec(protocol=protocol, workload=workload, configs=[{"hybrid": 63}], kernel_plane="kernel",
                              layout="node", devices=NODE_DEVICES)
        if path == NODE_NOWAIT:  # keep the run's arguments and final global store (the node_run hook's call)
            engine.run_sharded = keep_store
        try:
            res, got = counted_run(spec, counted)
        finally:
            engine.run_sharded = run_sharded
        if path == NODE_NOWAIT:
            log(res.plan.summary())
        row, n_ticks = res.row, spec.ticks + spec.warmup
        expect = {name: per * n_ticks for name, per in NODE_PER_TICK[protocol].items()}
        log(f"main path {path} (kernel plane, hybrid 63, {NODE_SHARDS} node shards on one card): {row['wall_s']:.3f} s "
            f"for {n_ticks} ticks, {n_ticks / row['wall_s']:.1f} ticks/s, commits={row['commits']} "
            f"aborts={row['aborts']}, launches {got} ({ {k: v / n_ticks for k, v in got.items()} } per tick)")
        if got != expect or row["n_node_shards"] != NODE_SHARDS:
            raise AssertionError(f"{path}: kernel launches {got} != {expect}")
        want = next(r for r in load(golden_file)["rows"] if r["hybrid"] == "111111")
        node_row_check(path, row, want, ("hybrid", "commits", "aborts"))
        log(f"{path} golden: counters equal the JAX reference's ({golden_file}, hybrid 111111)")
        launches[path], walls[path] = got, row["wall_s"]

    spec = ExperimentSpec(protocol="calvin", workload="smallbank", configs=[{"hybrid": 63}], kernel_plane="kernel",
                          layout="node", devices=NODE_DEVICES)
    res, got = counted_run(spec, counted)
    row = res.row
    cell = next(c for c in load("golden_calvin.json")["cells"] if c["spec"]["workload"] == "smallbank")
    want = next(r for r in cell["rows"] if r["hybrid"] == "111111")
    log(f"main path {NODE_CALVIN} (kernel plane, hybrid 63, {NODE_SHARDS} node shards): {row['wall_s']:.3f} s for "
        f"{calvin.epochs_for_ticks(spec.ticks)} epochs, commits={row['commits']} avg_waves={row['avg_waves']}, "
        f"launches {got}")
    if any(got.values()):
        raise AssertionError(f"{NODE_CALVIN}: no RCC kernel launch expected: {got}")
    node_row_check(NODE_CALVIN, row, want, ("hybrid", "commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves"),
                   ("throughput_mtps", "avg_latency_us"))
    log(f"{NODE_CALVIN} golden: the row equals the JAX reference's (golden_calvin.json, hybrid 111111)")
    launches[NODE_CALVIN], walls[NODE_CALVIN] = got, row["wall_s"]

    spec = ExperimentSpec(protocol="nowait", workload="smallbank", configs=[{"hybrid": c} for c in CODES],
                          kernel_plane="kernel", devices=NODE_DEVICES, node_shards=2)
    res, got = counted_run(spec, counted)
    log(res.plan.summary())
    n_ticks = spec.ticks + spec.warmup
    expect = {name: per * n_ticks for name, per in CONFIG_NODE_PER_TICK.items()}
    log(f"main path {CONFIG_NODE_PATH} (kernel plane, codes {CODES}, 2 config shards x 2 node shards on one card): "
        f"{res.wall_s:.3f} s, {len(CODES) / res.wall_s:.3f} configs/s, launches {got}")
    if res.plan.layout != "config_node" or got != expect or {r["n_node_shards"] for r in res.rows} != {2}:
        raise AssertionError(f"{CONFIG_NODE_PATH}: layout {res.plan.layout}, kernel launches {got} != {expect}")
    show_rows(CONFIG_NODE_PATH, res.rows, spec.warmup)
    golden_counters(CONFIG_NODE_PATH, res, "golden_nowait_smallbank.json")
    launches[CONFIG_NODE_PATH], walls[CONFIG_NODE_PATH] = got, res.wall_s

    # the NOWAIT path's final store against a dense run of the same config and ticks
    if len(kept) != 1:
        raise AssertionError(f"{NODE_NOWAIT}: engine.run_sharded ran {len(kept)} times, not once")
    (tick, ec, cm, wl, n_ticks, warmup), node_store, node_m = kept[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dense_store, dense_m = engine.run(tick, ec, cm, wl, n_ticks, warmup=warmup)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if set(node_store) != set(dense_store) or not all(torch.equal(node_store[k], dense_store[k]) for k in dense_store):
        raise AssertionError("nowait/smallbank: the node-sharded final store differs from the dense run's")
    if int(node_m["commits"][0]) != int(dense_m["commits"][0]):
        raise AssertionError("nowait/smallbank: node-sharded and dense commits differ")
    words = sum(v.numel() for v in dense_store.values())
    log(f"{NODE_NOWAIT} final store after {n_ticks} + {warmup} ticks: {len(dense_store)} arrays, {words} int32 words, "
        f"equal to the dense run's (engine.run {wall:.3f} s)")
    walls["nowait/smallbank/g1 engine.run"] = wall
    log("node walls_s: " + json.dumps(walls))
    return launches, walls


def legacy_call(fn, counted, *args, legacy=True, **kw):
    """``fn(*args, **kw)`` (a deprecated sweep entry point, its warning
    silenced) in the legacy PRNG mode, or the default one, with every
    kernel's launch count set to 0 just before and read just after:
    (rows, launches by kernel, wall s)."""
    import warnings

    from repro_torch.core import prng

    for f in counted:
        f.launches = 0
    t0 = time.perf_counter()
    with prng.threefry_partitionable(not legacy), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = fn(*args, **kw)  # rows hold Python values: the device has finished
    return out, {f.__name__: f.launches for f in counted}, time.perf_counter() - t0


def legacy_launches(path, protocol, got, n_ticks, per_tick):
    expect = {name: per * n_ticks for name, per in per_tick[protocol].items()}
    if got != expect:
        raise AssertionError(f"{path}: kernel launches {got} != {expect}")


def phase_legacy(counted, default_walls):
    """The legacy PRNG mode on the kernel plane, through the deprecated
    sweep entry points: ``run_grid`` over tests/data/stage_graph_golden.json's
    24 rows (taken by the reference in that mode), NOWAIT/SmallBank and
    MVCC/YCSB at the full spec on CODES against golden_legacy_prng.json
    with the torch plane's counters equal, and ``run_cell_sharded`` on four
    node shards of the one card for NOWAIT/SmallBank hybrid 63 against the
    same file; each run's launches per tick checked, its wall beside the
    same run in the default mode (``default_walls``: the full-size paths'
    walls from earlier phases of this run; the stage-graph runs have no
    default-mode wall: their re-runs were cut for the smoke's time limit).
    Returns the launches by path."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.core import sweep

    default = ExperimentSpec(protocol="nowait", workload="smallbank")  # the full spec's ticks and warm-up
    warmup = default.warmup
    with open(os.path.join(ROOT, "tests", "data", "stage_graph_golden.json")) as f:
        stage = json.load(f)
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_legacy_prng.json")) as f:
        golden = json.load(f)
    launches, walls = {}, {}
    total = {fn.__name__: 0 for fn in counted}
    n_ticks = STAGE_KW["ticks"] + STAGE_KW["warmup"]
    for protocol, workload, codes in STAGE_CELLS:
        configs = [{"hybrid": c} for c in codes]
        rows, got, wall = legacy_call(sweep.run_grid, counted, protocol, workload, configs, kernel_plane="kernel",
                                      **STAGE_KW)
        legacy_launches(f"{LEGACY_STAGE_PATH} {protocol}/{workload}", protocol, got, n_ticks, LEGACY_PER_TICK)
        total = {name: total[name] + n for name, n in got.items()}
        for r in rows:
            want = stage[f"{protocol}/{workload}/{r['hybrid']}"]
            if (r["commits"], r["aborts"]) != (want["commits"], want["aborts"]):
                raise AssertionError(f"{LEGACY_STAGE_PATH} {protocol}/{workload}/{r['hybrid']}: "
                                     f"{r['commits']}/{r['aborts']} != golden {want}")
        walls[f"{protocol}/{workload} stage grid"] = (wall, None)
        log(f"{LEGACY_STAGE_PATH} {protocol}/{workload} (kernel plane, {len(codes)} config(s), {n_ticks} ticks): "
            f"{[(r['hybrid'], r['commits'], r['aborts']) for r in rows]} equal the golden rows; legacy "
            f"{wall:.3f} s; launches {got}")
    log(f"{LEGACY_STAGE_PATH}: all {len(stage)} rows of tests/data/stage_graph_golden.json met on the kernel plane")
    launches[LEGACY_STAGE_PATH] = total

    for cell in golden["cells"]:
        spec = cell["spec"]
        protocol, workload, path = spec["protocol"], spec["workload"], f"legacy/{spec['protocol']}/{spec['workload']}"
        if spec["configs"] != [{"hybrid": c} for c in CODES]:
            raise AssertionError(f"golden_legacy_prng.json holds another spec: {spec}")
        rows, got, wall = legacy_call(sweep.run_grid, counted, protocol, workload, spec["configs"],
                                      kernel_plane="kernel")
        n_ticks = rows[0]["ticks"] + warmup
        legacy_launches(path, protocol, got, n_ticks, PER_TICK)
        counters = [{k: r[k] for k in ("hybrid", "commits", "aborts")} for r in rows]
        if counters != cell["rows"]:
            raise AssertionError(f"{path}: counters {counters} != JAX golden {cell['rows']}")
        rows_t, _, wall_t = legacy_call(sweep.run_grid, counted, protocol, workload, spec["configs"],
                                        kernel_plane="torch")
        for a, b in zip(rows, rows_t):
            for k in ("hybrid", "commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips"):
                if a[k] != b[k]:
                    raise AssertionError(f"{path}: planes disagree on {a['hybrid']} {k}: {a[k]} vs {b[k]}")
        show_rows(path, rows, warmup)
        walls[path] = (wall, default_walls[f"{protocol}/{workload}"])
        walls[f"{path} torch"] = (wall_t, default_walls[f"{protocol}/{workload} torch"])
        log(f"main path {path} (kernel plane, {len(CODES)} configs in one bucket, run_grid): legacy {wall:.3f} s, "
            f"default mode {default_walls[f'{protocol}/{workload}']:.3f} s (phase 4); torch plane legacy {wall_t:.3f} s; "
            f"launches {got}; counters equal golden_legacy_prng.json, planes agree bitwise")
        launches[path] = got

    want = next(r for r in golden["cells"][0]["rows"] if r["hybrid"] == "111111")
    row, got, wall = legacy_call(sweep.run_cell_sharded, counted, "nowait", "smallbank", {"hybrid": 63},
                                 devices=NODE_DEVICES, kernel_plane="kernel")
    n_ticks = default.ticks + warmup
    legacy_launches(LEGACY_NODE_PATH, "nowait", got, n_ticks, NODE_PER_TICK)
    node_row_check(LEGACY_NODE_PATH, row, want, ("hybrid", "commits", "aborts"))
    if row["n_node_shards"] != NODE_SHARDS:
        raise AssertionError(f"{LEGACY_NODE_PATH}: {row['n_node_shards']} node shards")
    walls[LEGACY_NODE_PATH] = (wall, default_walls[NODE_NOWAIT])
    log(f"main path {LEGACY_NODE_PATH} (kernel plane, hybrid 63, {NODE_SHARDS} node shards on one card, "
        f"run_cell_sharded): legacy {wall:.3f} s, default mode {default_walls[NODE_NOWAIT]:.3f} s (node phase), "
        f"commits={row['commits']} aborts={row['aborts']} equal golden_legacy_prng.json (111111), launches {got}")
    launches[LEGACY_NODE_PATH] = got
    log("legacy walls_s (legacy, default): " + json.dumps(walls))
    return launches



def ranking_swaps(got, want, rtol):
    """The hybrid search's ranking (``(throughput, latency, code)`` tuples,
    best first) against the reference's: the same code at every position,
    but where two neighbours of the reference's have equal throughputs and
    latencies within ``rtol`` of each other, which may come in either
    order.  Returns the code pairs that came swapped; raises on any other
    difference."""
    order, ref = [c for _, _, c in got], [c for _, _, c in want]
    if sorted(order) != sorted(ref):
        raise AssertionError(f"hybrid ranking: codes {sorted(order)} != {sorted(ref)}")
    swaps, i = [], 0
    while i < len(ref):
        if order[i] == ref[i]:
            i += 1
            continue
        a, b = want[i], want[i + 1] if i + 1 < len(want) else None
        close = b is not None and a[0] == b[0] and abs(a[1] - b[1]) <= rtol * max(abs(a[1]), abs(b[1]))
        if not (close and order[i] == ref[i + 1] and order[i + 1] == ref[i]):
            raise AssertionError(f"hybrid ranking differs at position {i}: {order[i]} where the reference has "
                                 f"{ref[i]} ({want[i]})")
        swaps.append((ref[i], ref[i + 1]))
        i += 2
    return swaps


def _checkout_module(name, rel):
    """A module of the checkout by path (examples/ and scripts/ are no packages)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KernelSpy:
    """Samples the kernel calls of a run.  Inside ``with``, every
    ``kernels.ops`` name that launches a hand-written kernel is wrapped:
    every call counts under its input signature (shapes, strides, dtypes,
    flags), and the first ``KEEP`` calls of a signature keep a copy of
    their inputs and of the output the run got, for :meth:`check`, which
    holds each kept output against the kernel's plain version on the kept
    inputs and times the signature most called per kernel.  Copies launch
    no kernel of ours, so the run's launch counts stay its own."""

    KERNELS = {"lock_arbiter": "lock_arbiter", "multi_read_many": "multi_read",
               "mvcc_version_read": "mvcc_version_select", "mvcc_version_select": "mvcc_version_select",
               "flash_attention": "flash_attention"}
    KEEP = 2

    def __init__(self):
        self.calls, self._saved = {}, {}

    @staticmethod
    def _copy(x):
        import torch

        if isinstance(x, torch.Tensor):
            return x.clone()  # keeps a dense view's strides
        if isinstance(x, (list, tuple)):
            return type(x)(KernelSpy._copy(t) for t in x)
        return x

    @staticmethod
    def _sig(x):
        import torch

        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), tuple(x.stride()), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(KernelSpy._sig(t) for t in x)
        return x

    def __enter__(self):
        from repro_torch.kernels import ops

        for entry in self.KERNELS:
            orig = self._saved[entry] = getattr(ops, entry)

            def spy(*args, _entry=entry, _orig=orig, **kw):
                out = _orig(*args, **kw)
                rec = self.calls.setdefault((_entry, self._sig(args), tuple(sorted(kw.items()))), [0, []])
                rec[0] += 1
                if len(rec[1]) < self.KEEP:
                    rec[1].append((self._copy(args), dict(kw), self._copy(out)))
                return out

            setattr(ops, entry, spy)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for entry, orig in self._saved.items():
            setattr(ops, entry, orig)

    def check(self, path):
        """Every kept call against the plain version (the RCC kernels
        exactly, flash_attention within 1e-5 + 1e-5 |want|), then the most
        called signature of each kernel timed: {kernel: timing row} with
        ``calls``, ``signatures`` and ``max_abs_err``."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import flash_attention_ref, gather_many_ref, mvcc_version_select_ref, \
            version_read_ref

        def plain(entry, args, kw):
            if entry == "lock_arbiter":
                return arbiter_ref(args)
            if entry == "multi_read_many":
                arrs, keys = args
                return tuple(r.reshape(tuple(keys.shape) + tuple(a.shape[1:]))
                             for r, a in zip(gather_many_ref(arrs, keys.reshape(-1)), arrs))
            if entry == "mvcc_version_read":
                return version_read_ref(*args)
            if entry == "mvcc_version_select":
                return mvcc_version_select_ref(*args)
            return flash_attention_ref(*args, **kw)

        def flat(x):
            return [t for t in (x if isinstance(x, (list, tuple)) else (x,)) if t is not None]

        rows, best = {}, {}
        for (entry, _, _), (n, kept) in self.calls.items():
            kernel = self.KERNELS[entry]
            err = 0.0
            for args, kw, got in kept:
                want = plain(entry, args, kw)
                torch.cuda.synchronize()
                for g, w in zip(flat(got), flat(want)):
                    if g.shape != w.shape:
                        raise AssertionError(f"{path}: {kernel} output {tuple(g.shape)} != plain {tuple(w.shape)}")
                    if kernel == "flash_attention":
                        d = (g.float() - w.float()).abs()
                        if not bool((d <= 1e-5 + 1e-5 * w.float().abs()).all()):
                            raise AssertionError(f"{path}: flash_attention misses its plain version by {d.max()}")
                        err = max(err, float(d.max()))
                    elif not torch.equal(g, w):
                        shapes = [tuple(t.shape) for t in flat(args[1] if entry == "multi_read_many" else args)]
                        raise AssertionError(f"{path}: {kernel} ({entry}) disagrees with its plain version at {shapes}")
            r = rows.setdefault(kernel, {"calls": 0, "signatures": 0, "max_abs_err": 0.0})
            r["calls"] += n
            r["signatures"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if n > best.get(kernel, (0, None))[0]:
                best[kernel] = (n, entry, kept[0])
        for kernel, (n, entry, (args, kw, _)) in best.items():
            fn = lambda: self._saved[entry](*args, **kw)  # noqa: E731
            if entry == "lock_arbiter":
                G, M = args[0].shape
                t = timed(fn, lambda: arbiter_ref(args))
                t["bound_ms"], t["bound_by"] = bound_ms(G * M * 14, 0)
                shape = f"G={G}, M={M}"
            elif entry == "multi_read_many":
                arrs, keys = args
                M, words = keys.numel(), sum(math.prod(a.shape[1:]) for a in arrs)
                t = timed(fn, lambda: plain(entry, args, kw), lambda: ops.gather_many(arrs, keys, plane=ops.TORCH))
                t["bound_ms"], t["bound_by"] = bound_ms(M * 4 + 2 * M * words * 4, 0)
                shape = f"{len(arrs)} arrays of {arrs[0].shape[0]} rows, {words} words a row, M={M}"
            elif entry == "mvcc_version_read":
                wh, _, keys = args[:3]
                (N, K), S, lock = keys.shape, wh.shape[1], args[5] is not None
                M = N * K
                t = timed(fn, lambda: plain(entry, args, kw))
                n_io = M * 4 + N * 8 + M * 2 * S * 4 + (M * 8 if lock else 0) + M * (5 + lock) + M * 2 * S * 4
                t["bound_ms"], t["bound_by"] = bound_ms(n_io, M * (12 * S + 6))
                shape = f"fused read N={N}, K={K}, S={S}, {'with' if lock else 'without'} the lock"
            elif entry == "mvcc_version_select":
                M, S = args[0].shape
                t = timed(fn, lambda: plain(entry, args, kw))
                t["bound_ms"], t["bound_by"] = bound_ms(M * (16 * S + 24), M * (12 * S + 6))
                shape = f"per-op M={M}, S={S}"
            else:
                q, k, v = args
                B, H, Sq, Dh = q.shape
                causal = kw.get("causal", True)
                qc, kc, vc = (x.contiguous() for x in (q, k, v))
                t = timed(fn, lambda: plain(entry, args, kw),
                          lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=causal))
                n_bytes, n_flops = attn_work(B, H, Sq, k.shape[2], Dh, causal, q.element_size())
                t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops, FP32_FLOPS_PER_S)
                shape = f"B={B}, H={H}, S={Sq}, Dh={Dh}, {'causal' if causal else 'not causal'}"
            rows[kernel].update(t, timed_signature=shape, timed_calls=n)
            log(f"{kernel} ({path}: {shape}, {n} of {rows[kernel]['calls']} calls): {t['ms']:.6f} ms/call on the "
                f"device ({t['host_ms']:.6f} issued eagerly), plain {t['plain_ms']:.6f} ({t['plain_host_ms']:.6f})"
                + (f", library {t['library_ms']:.6f}" if t.get("library_ms") is not None else "")
                + f", bound {t['bound_ms']:.9f} ms ({t['bound_by']}); {rows[kernel]['signatures']} signature(s), "
                f"{sum(len(k) for (e, _, _), (_, k) in self.calls.items() if self.KERNELS[e] == kernel)} calls "
                f"held to the plain version, max |err| {rows[kernel]['max_abs_err']:.3e}")
        return rows


# the examples phase: each user entry point at its own defaults, its launches counted from 0
EX_QUICKSTART, EX_SEARCH, EX_TXN = "examples/quickstart", "examples/hybrid_search", "examples/txn_serving"
EX_TRAIN, EX_TRAIN_FULL, EX_DEV = "examples/train_lm", "examples/train_lm --full", "examples/dev_smoke --fast"
# the example's --full run, cut to 120 steps (300 through PR 29) for the smoke's time limit
FULL_STEPS = 120
FULL_ARGV = ["--full", "--steps", str(FULL_STEPS), "--fail-at", "70"]
FULL_RESUME = 50  # the newest checkpoint before the failure: every 50 steps
EX_RTOL = 1e-5  # RCC float latencies (PERF.md §2)
EX_EXACT = ("commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips")
EX_CALVIN_EXACT = ("commits", "aborts", "abort_rate", "avg_round_trips", "avg_waves")


def example_rows(path, got, want):
    """RCC rows against the golden file's: counters bitwise, float latencies
    (CALVIN: also its float32 throughput) to EX_RTOL."""
    for a, b in zip(want, got):
        calvin = a.get("protocol") == "calvin"
        for k in EX_CALVIN_EXACT if calvin else EX_EXACT:
            if a[k] != b[k]:
                raise AssertionError(f"{path} {a.get('protocol', '')} {a['hybrid']}: {k} {b[k]} != golden {a[k]}")
        for k in ("avg_latency_us", "throughput_mtps") if calvin else ("avg_latency_us",):
            if not math.isclose(b[k], a[k], rel_tol=EX_RTOL):
                raise AssertionError(f"{path} {a['hybrid']}: {k} {b[k]} vs golden {a[k]}")
    if len(got) != len(want):
        raise AssertionError(f"{path}: {len(got)} rows, the golden file {len(want)}")


def rel_gap(got, want):
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def token_shas(batches):
    """sha256 of each token batch's int32 words (little-endian), as golden_examples.json holds them."""
    import hashlib

    return [hashlib.sha256(t.cpu().numpy().astype("<i4").tobytes()).hexdigest() for t in batches]


def phase_examples(counted):
    """The user entry points on the card at their own defaults, in process:
    examples/torch_quickstart.py, torch_hybrid_search.py (SUNDIAL/SmallBank,
    64 codes, 160 ticks), torch_txn_serving.py, torch_train_lm.py at its
    default and at ``--full --steps 120 --fail-at 70`` (beside the same run
    without the failure, bitwise), and scripts/torch_dev_smoke.py
    ``--fast`` for every arch; each against golden_examples.json (the JAX
    reference's outputs at the same knobs), its launches counted from 0 and
    checked against the paths' launches per tick and per layer, a sample of
    them held to the plain versions (``KernelSpy``).  Returns (launches by
    path, kernel timing rows by path, walls by path)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(ROOT, "src", "repro_torch", "data", "golden_examples.json")) as f:
        golden = json.load(f)
    tol = golden["tolerance"]
    tq = _checkout_module("torch_quickstart", "examples/torch_quickstart.py")
    th = _checkout_module("torch_hybrid_search", "examples/torch_hybrid_search.py")
    tt = _checkout_module("torch_txn_serving", "examples/torch_txn_serving.py")
    ttl = _checkout_module("torch_train_lm", "examples/torch_train_lm.py")
    tds = _checkout_module("torch_dev_smoke", "scripts/torch_dev_smoke.py")
    launches, timing, walls = {}, {}, {}

    def counted_call(path, fn, spy=True):
        for f in counted:
            f.launches = 0
        torch.cuda.synchronize()
        with KernelSpy() as sp:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[path] = time.perf_counter() - t0
        launches[path] = {f.__name__: f.launches for f in counted}
        log(f"{path}: {walls[path]:.3f} s, launches {launches[path]}")
        timing[path] = sp.check(path) if spy else {}
        return out

    def expect(path, want):
        if launches[path] != want:
            raise AssertionError(f"{path}: kernel launches {launches[path]} != {want}")

    def rcc(protocols, n_ticks):
        out = {"lock_arbiter": 0, "multi_read": 0, "mvcc_version_select": 0, "flash_attention": 0}
        for p in protocols:
            for name, n in LEGACY_PER_TICK.get(p, {}).items():
                out[name] += n * n_ticks
        return out

    # quickstart: six protocol pairs, the hybrid MVCC, the LM section
    q = counted_call(EX_QUICKSTART, lambda: tq.main([]))
    kw, g = tq.KW, golden["quickstart"]
    want = rcc(("nowait", "waitdie", "occ", "mvcc", "sundial", "mvcc"), kw["ticks"] + kw["warmup"])
    expect(EX_QUICKSTART, dict(want, flash_attention=q["lm"]["cfg"].n_layers))
    rows = [dict(m, protocol=p) for p, _, m in q["pairs"]] + [dict(q["hybrid"], protocol="mvcc")]
    example_rows(EX_QUICKSTART, rows, g["rows"])
    rcc_wall = sum(m["wall_s"] for _, impl, m in q["pairs"] if impl == "rpc") + q["hybrid"]["wall_s"]
    logits = q["lm"]["logits"].double().cpu()
    lm = g["lm"]
    head = float((logits[:, :, : lm["head"]] - torch.tensor(lm["logits_head"], dtype=torch.float64)).abs().max())
    total = abs(float(logits.sum()) - lm["logits_sum"]) / lm["logits_abs_sum"]
    loss = abs(q["lm"]["loss"] - lm["loss"]) / abs(lm["loss"])
    if list(logits.shape) != lm["logits_shape"] or max(head, total) > tol["quickstart_logits"] or \
            loss > tol["quickstart_loss"]:
        raise AssertionError(f"{EX_QUICKSTART} LM: logits gap {head}, sum gap {total}, loss gap {loss} against "
                             f"{tol['quickstart_logits']}, {tol['quickstart_loss']}")
    log(f"{EX_QUICKSTART} golden: 13 rows equal the reference's; LM logits within {max(head, total):.3e}, loss "
        f"within {loss:.3e} (tolerances {tol['quickstart_logits']:.3e}, {tol['quickstart_loss']:.3e}); "
        f"{len(rows)} configs in {rcc_wall:.3f} s of RCC buckets, {len(rows) / rcc_wall:.3f} configs/s")

    # hybrid search: the 64 codes as one bucket
    hrows = counted_call(EX_SEARCH, lambda: th.main([]))
    g = golden["hybrid_search"]
    expect(EX_SEARCH, rcc(("sundial",), g["spec"]["ticks"] + g["spec"]["warmup"]))
    example_rows(EX_SEARCH, hrows, g["rows"])
    want_rank = [(r["throughput_mtps"], r["avg_latency_us"], r["hybrid"])
                 for r in sorted(g["rows"], key=lambda r: g["ranking"].index(r["hybrid"]))]
    swaps = ranking_swaps(th.rank(hrows), want_rank, EX_RTOL)
    log(f"{EX_SEARCH} golden: 64 rows equal the reference's, its ranking held"
        + (f" but for neighbours within rtol {EX_RTOL}: {swaps}" if swaps else "")
        + f"; {64 / hrows[0]['wall_s']:.3f} configs/s")

    # txn_serving: the admission run, then the reduced serve
    m, store = counted_call(EX_TXN, lambda: tt.main([]))
    a = golden["admission"]
    expect(EX_TXN, dict(rcc(("nowait",), a["ticks"] + a["warmup"]), flash_attention=4))
    got = [m[k] for k in EX_EXACT] + [int(store["data"].sum())]
    if got != [a[k] for k in EX_EXACT] + [a["page_sum"]] or not math.isclose(m["avg_latency_us"],
                                                                             a["avg_latency_us"], rel_tol=EX_RTOL):
        raise AssertionError(f"{EX_TXN}: admission {m}, page sum {got[-1]} against golden {a}")
    log(f"{EX_TXN} golden: admissions {m['commits']}, aborts {m['aborts']}, page generations {got[-1]} equal the "
        "reference's")

    # train_lm: the reduced default, then --full with a failure beside the same run without it
    out = counted_call(EX_TRAIN, lambda: ttl.main([]), spy=False)
    g = golden["train_lm"]
    expect(EX_TRAIN, rcc((), 0))
    gap = rel_gap(out["losses"], g["losses"])
    if token_shas(out["tokens"]) != g["tokens_sha256"] or gap > tol["train_lm_losses"]:
        raise AssertionError(f"{EX_TRAIN}: tokens differ, or losses {gap} off (tolerance {tol['train_lm_losses']})")
    log(f"{EX_TRAIN} golden: 120 token batches bitwise, losses within {gap:.3e} relative (tolerance "
        f"{tol['train_lm_losses']:.3e})")
    failed = counted_call(EX_TRAIN_FULL, lambda: ttl.main(FULL_ARGV), spy=False)
    expect(EX_TRAIN_FULL, rcc((), 0))
    t0 = time.perf_counter()
    clean = ttl.train(FULL_STEPS, full=True)
    walls[f"{EX_TRAIN_FULL} without the failure"] = time.perf_counter() - t0
    # where a --full step's time goes: two more steps of the run without the failure, the second profiled, beside
    # the step's float32 bound (6 N T flops over the FMA rate)
    from repro_torch.data.pipeline import DataState, make_pipeline
    from repro_torch.train.steps import build_train_step

    cfg_full, batch, seq = ttl.config(True)
    step_fn, _ = build_train_step(cfg_full)
    _, draw = make_pipeline(cfg_full.vocab_size, batch, seq, copy_frac=ttl.COPY_FRAC, device="cuda")
    for i in (FULL_STEPS, FULL_STEPS + 1):
        _, b = draw(DataState(i, 0))
        _, wall, busy, n_ops, top, _ = device_busy(lambda: step_fn(clean["params"], clean["opt"], i, b))
    n_params = sum(p.numel() for p in clean["params"].parameters())
    bound = 6 * n_params * batch * seq / FP32_FLOPS_PER_S * 1e3
    log(f"{EX_TRAIN_FULL} profile: " + json.dumps({
        "step_wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall, "device_ops": n_ops,
        "bound_ms": bound, "bound_by": "operations (6 N T float32 flops)", "params": n_params, "top_ms": top}))
    f, c, fail_at = failed["losses"], clean["losses"], int(FULL_ARGV[-1])
    if f[:fail_at] != c[:fail_at] or f[fail_at:] != c[FULL_RESUME:] or \
            token_shas(failed["tokens"][fail_at:]) != token_shas(clean["tokens"][FULL_RESUME:]):
        raise AssertionError(f"{EX_TRAIN_FULL}: the run with the failure differs from the run without it")
    g = golden["train_lm_full"]
    gap = rel_gap(f[:3], g["losses"])
    if token_shas(failed["tokens"][:3]) != g["tokens_sha256"] or gap > tol["train_lm_full_losses"]:
        raise AssertionError(f"{EX_TRAIN_FULL}: first tokens differ, or losses {gap} off")
    log(f"{EX_TRAIN_FULL} golden: the failure at {fail_at} replayed from step {FULL_RESUME}, its {len(f)} losses the "
        f"run without it bitwise ({walls[EX_TRAIN_FULL]:.3f} s against "
        f"{walls[EX_TRAIN_FULL + ' without the failure']:.3f} s), the first 3 within {gap:.3e} of the reference "
        f"(tolerance {tol['train_lm_full_losses']:.3e}); loss {f[0]:.4f} -> {f[-1]:.4f}")

    # dev smoke --fast, every arch
    d = counted_call(EX_DEV, lambda: tds.main(["--fast"]))
    g = golden["dev_smoke_matrix"]
    n_ticks = g["kw"]["ticks"] + g["kw"]["warmup"]
    want = rcc(("nowait", "waitdie", "occ", "mvcc", "sundial"), n_ticks)
    got = launches[EX_DEV]
    if {k: v for k, v in got.items() if k != "flash_attention"} != {k: v for k, v in want.items()
                                                                     if k != "flash_attention"} \
            or not got["flash_attention"]:
        raise AssertionError(f"{EX_DEV}: kernel launches {got}, expected {want} and flash_attention")
    if {k: list(v) for k, v in d["matrix"].items()} != g["commits"] or len(d["lm"]) != 10:
        raise AssertionError(f"{EX_DEV}: matrix commits {d['matrix']} != golden {g['commits']}")
    log(f"{EX_DEV} golden: matrix commits equal the reference's; {len(d['lm'])} archs' forward, step, prefill and "
        f"decode ok, largest prefill/decode gap to the forward "
        f"{max(max(r['err_prefill'], r['err_decode']) for r in d['lm'].values()):.3e}")
    for kernel in ("lock_arbiter", "multi_read", "mvcc_version_select", "flash_attention"):
        if not any(launches[p][kernel] for p in launches):
            raise AssertionError(f"examples: {kernel} never launched")
    log("examples walls_s: " + json.dumps(walls))
    return launches, timing, walls

def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lock_arbiter import lock_arbiter
    from repro_torch.kernels.multi_read import multi_read
    from repro_torch.kernels.mvcc_version_select import mvcc_version_select

    counted = (lock_arbiter, multi_read, mvcc_version_select, flash_attention)
    # float32 products stay float32: a TF32 product would blow the serving phase's tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {torch.cuda.get_device_name(0)}")
    walls, t_lap = {}, time.perf_counter()

    def lap(name):
        """Record the wall seconds since the last lap under ``name``."""
        nonlocal t_lap
        now = time.perf_counter()
        walls[name] = round(now - t_lap, 1)
        t_lap = now

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"build: {len(build_logs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    lap("build")

    kernels = phase_kernels()
    lap("kernels")
    phase_shard_kernels(torch.Generator().manual_seed(1), kernels)
    lap("node kernels")
    for protocol, workload in (("nowait", "smallbank"), ("mvcc", "ycsb")):
        for codes in ((63,), CODES):
            phase_profile(protocol, workload, codes)
        phase_profile(protocol, workload, (63,), devices=NODE_DEVICES)
    phase_profile("nowait", "smallbank", tuple(range(64)))
    lap("profiles")

    launches = {k["name"]: {} for k in kernels}
    configs_per_s, default_walls = {}, {}
    for protocol, workload, golden_file in PATHS:
        path = f"{protocol}/{workload}"
        # phase 4: the main path on the kernel plane, one batched run; launches counted from 0
        res, got = counted_run(main_path_spec(protocol, workload, "kernel"), counted)
        log(res.plan.summary())
        n_ticks = check_launches(path, protocol, res, got)
        log(f"main path {path} (kernel plane, {len(CODES)} configs in one bucket): {res.wall_s:.3f} s for "
            f"{n_ticks} batched ticks, {len(CODES) / res.wall_s:.3f} configs/s, launches {got}")
        show_rows(f"{path} kernel", res.rows, res.plan.spec.warmup)
        for name, n in got.items():
            launches[name][path] = n
        configs_per_s[f"{path} G={len(CODES)} kernel"] = len(CODES) / res.wall_s
        default_walls[path] = res.wall_s

        # phase 5: the torch plane gives the same counters
        res_t = api.run(main_path_spec(protocol, workload, "torch"))
        log(f"main path {path} (torch plane, {len(CODES)} configs in one bucket): {res_t.wall_s:.3f} s, "
            f"{len(CODES) / res_t.wall_s:.3f} configs/s")
        show_rows(f"{path} torch", res_t.rows, res_t.plan.spec.warmup)
        configs_per_s[f"{path} G={len(CODES)} torch"] = len(CODES) / res_t.wall_s
        default_walls[f"{path} torch"] = res_t.wall_s
        for a, b in zip(res.rows, res_t.rows):
            for k in ("hybrid", "commits", "aborts", "abort_rate", "throughput_mtps", "avg_round_trips"):
                if a[k] != b[k]:
                    raise AssertionError(f"{path}: planes disagree on {a['hybrid']} {k}: {a[k]} vs {b[k]}")
        log(f"{path}: planes agree bitwise on the counters")

        # phase 6: the JAX reference's golden counters, on both planes
        golden = golden_counters(f"{path} kernel", res, golden_file)
        golden_counters(f"{path} torch", res_t, golden_file)
        if golden["spec"] != {"protocol": protocol, "workload": workload, "configs": [{"hybrid": c} for c in CODES]}:
            raise AssertionError(f"{golden_file} holds another spec: {golden['spec']}")

    lap("rcc main paths")
    # configs per second at G = 1 (hybrid 63 alone) and G = 64 (the 64-code sweep)
    res1, got = counted_run(main_path_spec("nowait", "smallbank", "kernel", (63,)), counted)
    n_ticks = check_launches(ONE_PATH, "nowait", res1, got)
    log(f"main path {ONE_PATH} (kernel plane, hybrid 63 alone): {res1.wall_s:.3f} s for {n_ticks} ticks, "
        f"{1 / res1.wall_s:.3f} configs/s, launches {got}")
    golden_counters(ONE_PATH, res1, "golden_nowait_smallbank.json")
    for name, n in got.items():
        launches[name][ONE_PATH] = n
    configs_per_s["nowait/smallbank G=1 kernel"] = 1 / res1.wall_s
    res64, got = phase_sweep(counted)
    for name, n in got.items():
        launches[name][SWEEP_PATH] = n
    configs_per_s["nowait/smallbank G=64 kernel"] = 64 / res64.wall_s
    log("configs_per_s: " + json.dumps(configs_per_s))

    lap("configs per second")
    for name, n in phase_calvin(counted).items():
        launches[name][CALVIN_PATH] = n
    lap("calvin")

    # the node-sharded layouts: four node shards on the one card
    node_launches, node_walls = phase_node(counted)
    for path, got in node_launches.items():
        for name, n in got.items():
            launches[name][path] = n
    default_walls[NODE_NOWAIT] = node_walls[NODE_NOWAIT]

    lap("node layouts")
    # the legacy PRNG mode through the deprecated sweep entry points
    for path, got in phase_legacy(counted, default_walls).items():
        for name, n in got.items():
            launches[name][path] = n

    lap("legacy prng")
    # phase 7: the LM serving path (stablelm-1.6b at full width)
    for name, n in phase_serve(counted).items():
        launches[name][SERVE_PATH] = n

    lap("serve stablelm")
    # the MoE serving path (llama4-scout-17b-a16e at full width, MOE_LAYERS of 48 layers)
    got, moe_params = phase_serve_moe(counted)
    for name, n in got.items():
        launches[name][MOE_SERVE_PATH] = n

    lap("serve moe")
    # the same model on a 1 x 4 mesh of shards on the one card, on the MoE phase's parameters
    for name, n in phase_serve_moe_mesh(counted, moe_params).items():
        launches[name][MESH_SERVE_PATH] = n
    del moe_params
    lap("serve moe 1x4")
    # the SSM serving path (falcon-mamba-7b at full width, SSM_LAYERS of 64 layers)
    for name, n in phase_serve_ssm(counted).items():
        launches[name][SSM_SERVE_PATH] = n

    lap("serve ssm")
    # the hybrid serving path (recurrentgemma-2b at full width and depth)
    for name, n in phase_serve_hybrid(counted).items():
        launches[name][HYBRID_SERVE_PATH] = n

    lap("serve hybrid")
    # the encoder-decoder serving path (whisper-small at full width and depth)
    for name, n in phase_serve_whisper(counted).items():
        launches[name][WHISPER_SERVE_PATH] = n

    lap("serve whisper")
    # the M-RoPE VLM serving path (qwen2-vl-72b at full width, VLM_LAYERS of 80 layers)
    for name, n in phase_serve_vlm(counted).items():
        launches[name][VLM_SERVE_PATH] = n

    lap("serve vlm")
    # the last three dense configs (nemotron-4-15b, qwen2.5-32b, command-r-35b at full width)
    for path, got in phase_serve_dense(counted).items():
        for name, n in got.items():
            launches[name][path] = n

    lap("serve dense")
    # kimi-k2-1t-a32b at full width, 1 of 61 layers
    for name, n in phase_serve_kimi(counted).items():
        launches[name][KIMI_SERVE_PATH] = n

    lap("serve kimi")
    # phase 8: the LM training path (stablelm-1.6b at full width and depth)
    for name, n in phase_train(counted).items():
        launches[name][TRAIN_PATH] = n

    lap("train")
    # the SSM, hybrid and encoder-decoder training paths (falcon-mamba-7b, recurrentgemma-2b, whisper-small)
    for path, got in phase_train_families(counted).items():
        for name, n in got.items():
            launches[name][path] = n

    lap("train families")
    # the M-RoPE VLM training path (qwen2-vl-72b at full width, 1 of 80 layers, 2 microbatches a step)
    for name, n in phase_train_vlm(counted).items():
        launches[name][TRAIN_FAMILY_PATH + VLM_ARCH] = n

    lap("train vlm")
    # the MoE training path on meshes of shards (llama4-scout-17b-a16e at full width, 1 of 48 layers)
    for path, got in phase_train_moe_mesh(counted).items():
        for name, n in got.items():
            launches[name][path] = n

    lap("train moe mesh")
    # the user entry points: the four examples and the dev smoke, at their own defaults
    ex_launches, ex_timing, _ = phase_examples(counted)
    log(card)
    for path, got in ex_launches.items():
        for name, n in got.items():
            launches[name][path] = n
    for k in kernels:  # the examples' calls of each kernel, timed on the calls the run made
        for path, rows in ex_timing.items():
            if k["name"] in rows:
                k["by_path"][path] = rows[k["name"]]

    for k in kernels:  # launches summed over the main paths' runs; times weighted by them
        k["launches"] = sum(launches[k["name"]].values())
        k["launches_by_path"] = launches[k["name"]]
        weighted = [(launches[k["name"]][p], r) for p, r in k["by_path"].items()]
        mean = mix(weighted)
        k.update({key: mean[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "host_ms", "plain_host_ms")})
        # the library call's mean over the paths that have one (none reads zeros for another shard's keys),
        # beside the kernel's own mean over those paths
        lib = [(n, r) for n, r in weighted if r.get("library_ms") is not None]
        k.update({key: mix(lib)[key] if lib else None for key in ("library_ms", "library_host_ms")})
        k["ms_library_paths"] = mix(lib)["ms"] if lib else None
    lap("examples")
    log("phase walls (s): " + json.dumps(walls))
    log(card)  # again, so that the card and its power limit stand beside the numbers in a tail of the output
    log(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
