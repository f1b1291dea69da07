#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — requires CUDA (exits non-zero without it); card name and
               power limit from nvidia-smi.
2. build    — builds every kernel in src/repro_torch/kernels/csrc with nvcc
               for sm_90a, one nvcc per source, all started together; ptxas's
               registers, stack and spills per kernel.
3. kernel_check  — each kernel against its plain PyTorch version on the card
               (f32 to 2e-5, bf16 to 2e-2; ddpm_step_bwd bit for bit), at
               the paths' shapes; ddpm_chain and ssd_scan also against an
               exact f64 answer; the gradients of reverse_sample(impl=
               "step") at the paper's actor (R = 64) through the forward
               and backward kernels against the plain step loop; the
               chain's gradients through ddpm_chain's record and
               ddpm_chain_bwd against the plain backward (2e-5 of each
               leaf's max) and the exact f64 gradients, the same bits
               twice, one launch of each per gradient; both chain
               kernels with the learner axis (STACKED_CASES: every (B, R)
               that the vector-env phase launches, B = 8 and 4 at the
               updates' R = 64 and acting's R = 1, then B = 3 over odd
               widths, B = 1) against the plain stacked versions, and each
               learner's slice bit for bit against the single-learner
               launch on its weights.
4. kernel_timing — CUDA-event times of kernel and plain version, in turns,
               beside the card's bound for the same bytes and flops, and
               ``graph_ms``: the same launches replayed from one CUDA graph
               (the device's own time, no Python or ctypes in it); for
               ddpm_chain also the step path's time for the same chain and
               the forward with its record against the forward without;
               for ddpm_chain_bwd the forward + backward of a policy chain
               through the chain and through the step path; the stacked
               chains of the vector-env phase (B = 8 and 4 learners, R = 1
               and 64, with and without the record, and the backward)
               beside the B single-learner launches they replace.
5. train         — single-cell training at the paper's EnvCfg(): t2drl
               (d3pg/ddqn) for 8 episodes under benchmarks/common.py's
               method_cfg settings (tuned lrs, warmup 100), export_policy
               and 2 greedy eval_t2drl episodes, then 2 episodes each of
               ddpg/ddqn and rcars/static; requires the gates' update
               counts (700 D3PG, 40 DDQN), every learned parameter changed,
               finite losses, and the exact launch counts: ddpm_chain
               T*K*episodes + 2 per update, ddpm_chain_bwd 1 per update,
               no ddpm_step or ddpm_step_bwd; then 50 D3PG updates with
               each impl of the policy chain ("chain", "step"): host ms,
               device ms, idle share, device kernels per update, and
               their exact launches.
5b. vector       — vector-env training at the paper's EnvCfg() under the same
               settings: train_t2drl(num_envs=8) with fused independent
               learners for 2 episodes (exact launches: one ddpm_chain a
               slot for all 8 actors, 2 ddpm_chain + 1 ddpm_chain_bwd a
               stacked update, whatever B; every learner changed; history
               (episodes, B)); the shared learner over 4 cells with
               user_counts [10, 8, 6, 4]; train_population of 4 members
               (lr_actor x eps_end) for 2 episodes and its ranking; one
               greedy schrs/ddqn episode (SCHRS ms per slot) and a
               lockstep SCHRS batch_act over 4 cells; then one fused
               update at B = 8 against 8 single-learner updates (host ms,
               device ms, idle share).
5c. ops          — the operations slice at the paper's EnvCfg(), warmup 20
               (every one-episode run updates): one d3pg training episode
               with each classical cacher (lru, lfu, lru-ghost, arc) and
               two of 8 fused cells with arc (storage within budget every
               frame, resident units within the capacity, hit ratios in
               [0, 1]); one frame's replay of each policy on the card
               against the CPU's, bit for bit, at 1 and 8 cells (ms and
               device kernels per frame); every built-in scenario for one
               training and one greedy eval episode (hetero-cells and
               degraded-channel at 4 cells), paper-default the unmodulated
               run bit for bit; a 2-episode state through
               save_train_state/load_train_state onto the card (every leaf
               equal, the same greedy episode), a 4-cell state and an ARC
               policy; one episode with telemetry and a MetricWriter (the
               log validates, the reference's diag/ keys, diag/updates the
               gated count, the same launches as without it) and one
               diag=True update through ddpm_chain's record with the plain
               chain made to raise.  Every run's launches exact.
6. control_plane — greedy T2DRL episodes at the paper's EnvCfg() (d3pg/ddqn,
               then rcars/random); checks stats, simplexes, and that
               ddpm_chain ran once per slot (T*K per d3pg episode); then one
               episode with impl="step" from the same seed as one with the
               default chain: L*T*K ddpm_step launches, the same actions.
7. data_plane    — the edge gateway loop of examples/serve_edge.py against the
               port: 10 diffusion models at image_dim=256, total_steps=1000,
               3 frames x 4 slots; checks one ddpm_chain launch per chain
               (the actor's per slot, one per served image).
8. lm_plane      — the gateway's LM branch: qwen2-0.5b and mamba2-130m at full
               width (random weights from seeds), each behind an Engine
               (max_batch=4, max_seq=512), beside a diffusion model; a few
               gateway slots, then one Engine.run of 8 requests per model
               (prompt lengths 4-300); checks 24 flash_attention launches
               per qwen2 prefill, 24 ssd_scan launches per mamba2 prefill,
               one ddpm_chain per image, finite logits, and one prefill
               through the kernels against the plain versions.
9. fleet         — the request-level fleet twin (repro_torch.fleet) at the
               paper's EnvCfg() and FleetCfg() over 64 cells, one horizon
               (100 slots of 20 ticks), on the 2-episode state that phase
               ops checkpointed (restored with load_train_state) and an
               rcars/random state: wall s a horizon, requests per wall
               second, the reference's summary keys; conservation exact;
               one ddpm_chain launch a slot whatever the fleet size; device
               kernels a slot; cell 0's arrivals those of a one-cell fleet
               from the same seed (run right after phase ops).
10. lm_archs     — every architecture of the registry, one at a time and
               freed before the next, f32 weights from seeds: the nine
               decoder-only ones behind Engine(max_batch=4, max_seq=512),
               4 prompts of 8-300 tokens, 16 new tokens each (internvl2-2b
               also one prefill behind its 256 patch slots), whisper-small
               through whisper_prefill/whisper_decode on (1, 1500, 768)
               frame embeddings; full width and depth but deepseek-v2-236b
               (2 layers: 1 dense, 1 MoE of 160 experts) and
               deepseek-v3-671b (its smoke width), each cut listed under
               ``reduced``; launches exact (one flash_attention per
               attention layer, one ssd_scan per Mamba2 layer a prefill:
               zamba2-7b 13 at d_head 112 and 68); one prefill against the
               plain versions; prefill ms, decode tokens/s, weight bytes.
11. arch_timing  — flash_attention (with SDPA) and ssd_scan timed at every
               shape phase 10 launched that phase 4 did not time.
12. lm_train     — LM training (f32 weights from seeds, bf16 compute, the
               training CLI's batch 8, seq 128, lr 3e-4): qwen2-0.5b and
               mamba2-130m at full width for 20 steps through train_loop
               with a checkpoint (finite losses and gnorms, the schedule's
               lr every step, every parameter changed; s/step, tokens/s,
               peak memory; one step's host ms, device ms, idle share and
               kernels, step_cost's FLOPs, useful_ratio and mfu);
               qwen2-0.5b at batch 1, L = 2048 through the plain and the
               chunked attention (s/step, peak memory, the same loss);
               whisper-small at full width and deepseek-v3-671b at its
               smoke width for 5 steps; every other architecture one
               step at its smoke config; qwen2-0.5b's smoke config for 60
               steps at lr 3e-3, batch 8, seq 64, its loss down by more
               than 0.5.  No flash_attention or ssd_scan launch while
               training.  Both checkpoints read back onto the card (bit
               for bit) and served behind Engine(max_batch=4, max_seq=512)
               with exact launches (24 flash_attention a qwen2 prefill, 24
               ssd_scan a mamba2 prefill) and one prefill against the
               plain versions.
13. dist         — the multi-device path on torch.distributed: run_training
               of 8 fused cells at the paper's EnvCfg() for 2 episodes in
               this process, then run_training_sharded of the same cells
               in a world of one rank (NCCL on cuda:0) and in a world of
               two gloo ranks on the one card (4 cells each; NCCL refuses
               two ranks on one device), each started by spawn_ranks with
               a deadline after phase build, so no rank runs nvcc: every
               rank's state and history bit for bit this process's,
               its ddpm_chain and ddpm_chain_bwd launches exactly this
               process's; wall s per episode, the gather's bytes and ms.
               The world of two also runs one deepseek-v2-236b MoE layer
               at full width in bf16 expert-parallel on a ("model",) mesh
               against the layer unsharded, and deepseek-v3-671b's smoke
               forward with PerfOpts(moe_shardmap=True)'s config against
               the unsharded one.  The world of one also runs the LM's
               mesh half on a (1, 1) ("data", "model") mesh: qwen2-0.5b's
               and mamba2-130m's prefill and 16 decode steps through the
               kernels on DTensor weights, and two FSDP train steps of
               qwen2-0.5b, each bit for bit the unsharded run (the
               two-rank meshes stay in the CPU tests: gloo does not carry
               DTensor's CUDA collectives, scripts/probe_gloo_cuda.py).
               Then the three example twins
               (examples/*_torch.py) run as subprocesses with reduced
               arguments, each exiting 0 with finite results.

Phases 3 and 4 cover every kernel: ddpm_step, ddpm_step_bwd, ddpm_chain
(at the control and data planes' chains, R = 16 and 64, and odd widths),
ddpm_chain_bwd (at the actor's chains, R = 1 to 1024, odd widths),
flash_attention (at the prefill buckets of phase 8 and at
tests/test_kernels.py's FLASH_CASES) and ssd_scan (likewise, SSD_CASES).
Then a ``kernels`` line (per kernel: route, source, the TPU kernel it
replaces, launches on the paths, error, times, bound and library time at
the most frequent shape; grids per call, as the C entry points report
them on the paths;
``path_ms`` and ``path_bound_ms``, launches times ms or bound summed over
the shapes the paths ran; times at other shapes under ``at``) and, last,
``{"ok": true, "device": {...}}``.  Launch and grid counts are reset just
before each path runs (training, serving) and read just after, so
comparison and timing launches do not count.
Phases 5-10, 12 and 13 take a device, so the CPU tests run them small.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.d3pg import (amend_actions,  # noqa: E402
                                   make_actor_schedule)
from repro_torch.core.env import (EnvCfg, ModelParams,  # noqa: E402
                                  env_advance_frame, env_cell, env_reset,
                                  env_reset_batch, env_set_cache,
                                  env_step_slot, make_models,
                                  make_models_batch, make_user_masks,
                                  observe)
from repro_torch.core.networks import mlp_init, stack_mlps  # noqa: E402
from repro_torch.agents import SlotObs, make_allocator  # noqa: E402
from repro_torch.core.baselines import (GACfg,  # noqa: E402
                                        static_popular_cache)
from repro_torch.core.cache_policies import (  # noqa: E402
    CACHE_POLICIES, cache_rho, cache_state_init, quantize_capacity,
    quantize_sizes)
from repro_torch.checkpoint import (load_train_state,  # noqa: E402
                                    save_train_state)
from repro_torch.core.buffers import (buffer_cell,  # noqa: E402
                                      buffer_sample, buffer_sample_stacked)
from repro_torch.core.population import (PopMember,  # noqa: E402
                                         rank_population, train_population)
from repro_torch.core import t2drl as t2drl_mod  # noqa: E402
from repro_torch.core.t2drl import (STAT_KEYS, T2DRLCfg,  # noqa: E402
                                    cell_generators, cell_state, eval_t2drl,
                                    export_policy, greedy_frame_cache,
                                    greedy_slot_action, policy_init,
                                    run_eval, run_eval_batch, run_training,
                                    run_training_sharded, t2drl_init,
                                    t2drl_init_batch, train_t2drl)
from repro_torch.device import make_generator, resolve_device  # noqa: E402
from repro_torch.diffusion import (Denoiser, make_schedule,  # noqa: E402
                                   reverse_sample, time_embedding)
from repro_torch.diffusion.sampler import chain_tables  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.bridge import lm_train_state_from_numpy  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.launch.roofline import (PEAK_FLOPS,  # noqa: E402
                                         active_fraction, model_flops,
                                         roofline, step_cost)
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.mesh import (make_cells_mesh,  # noqa: E402
                                     mesh_device_type, spawn_ranks)
from repro_torch.launch.steps import PerfOpts, param_shapes  # noqa: E402
from repro_torch.launch.train import train_loop, train_setup  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.nn import moe as moe_mod  # noqa: E402
from repro_torch.nn.core import count_params  # noqa: E402
from repro_torch.nn.sharding import is_dtensor, use_mesh  # noqa: E402
from repro_torch.nn.sharding import distribute as shard_spec  # noqa: E402
from repro_torch.serving import (CatalogEntry, EdgeGateway,  # noqa: E402
                                 Engine, ServeCfg, toy_diffusion_builder)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import _bucket  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash_attention beside the allclose: ||out - ref|| / ||ref||, over all rows
# and over the rows past L/2, whose outputs (means over many keys) are as
# small as the bf16 allclose tolerance.  Rounding p and the output to bf16
# gives ~1e-3; dropping one 64-key tile of a row near 4096 gives ~0.2.
FLASH_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SSD_TOL = 2e-4      # tests/test_kernels.py: the chunked SSD, f32
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12       # f32 on CUDA cores
BF16_FLOPS = 989e12     # bf16 on tensor cores, dense

KERNEL_CHECK_SHAPES = [((20,), torch.float32), ((1, 20), torch.float32),
                       ((64, 20), torch.float32), ((2, 3, 40), torch.float32),
                       ((1, 7), torch.float32), ((256,), torch.float32),
                       ((8, 256), torch.bfloat16),
                       ((4096, 256), torch.float32)]
TIMING_SHAPES = [(20,), (64, 20), (256,), (65536, 256)]
# the backward: its training-path shape (64, 20) and the forward's shapes
BWD_SHAPES = [(20,), (64, 20), (256,), (65536 * 256,)]
DDPM_COEF = (0.9, 0.5, 0.04)          # alpha, alpha_bar, beta_tilde

# ddpm_chain cases (name, MLP widths, S, R, L, schedule): the control
# plane's actor (86 -> 128x3 -> 20, L = 5) at R = 1, 16 and 64 (a D3PG
# update's target chain over its minibatch), the data plane's
# image chain (273 -> 128x3 -> 256) at L = 1, 50 and 1000, widths that the
# cluster of 8 does not divide (90, 30) over two row blocks (R = 9), and
# CTAs left with no column of the last layer (5 wide over 8 CTAs)
CTRL_DIMS, DATA_DIMS = (86, 128, 128, 128, 20), (273, 128, 128, 128, 256)
CHAIN_CASES = [("control", CTRL_DIMS, 50, 1, 5, "paper"),
               ("control_R16", CTRL_DIMS, 50, 16, 5, "paper"),
               ("data_L1", DATA_DIMS, 1, 1, 1, "linear"),
               ("data_L50", DATA_DIMS, 1, 1, 50, "linear"),
               ("data_L1000", DATA_DIMS, 1, 1, 1000, "linear"),
               ("odd_widths", (53, 90, 90, 90, 30), 7, 9, 7, "paper"),
               ("empty_slice", (25, 100, 100, 5), 4, 2, 3, "paper"),
               ("control_R64", CTRL_DIMS, 50, 64, 5, "paper"),
               ("control_R4", CTRL_DIMS, 50, 4, 5, "paper")]


def chain_exact_tol(L: int) -> float:
    """Tolerance of a chain against its exact f64 run: 2e-5 per 50 steps.
    A long chain amplifies f32 rounding: x grows by up to the product of
    c1 (~1/sqrt(abar), ~150 at L = 1000 of the linear schedule), and the
    plain version itself lies ~3x 2e-5 from the exact answer there."""
    return TOL[torch.float32] * max(1.0, L / 50)

# prefill lengths of the LM plane: the engine's buckets at max_seq = 512
PATH_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
LONG_L = 4096                         # a timing shape off the path
QWEN_HEADS = (14, 2, 64)              # H, Hkv, d_head of qwen2-0.5b
# DeepSeek-V2/V3's expanded MLA prefill: H = Hkv = 128, q/k of 128 nope +
# 64 rope, v of 128, and V3's softmax scale (1/sqrt(192) times YaRN's
# mscale(40, 1)^2); timed at the DeepSeek serve cell's prompt buckets
MLA_HEADS = (128, 128, 192, 128)
MLA_SCALE = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
MLA_TIMING_L = (512, 1024, 2048, 4096)
MAMBA_SSD = (24, 64, 1, 128, 128)     # H, P, G, N, chunk of mamba2-130m
# (B, H, Hkv, L, S, D, window, dtype, causal): FLASH_CASES of
# tests/test_kernels.py, one non-causal case, and qwen2-0.5b's prefills
FLASH_CHECK_CASES = [
    (2, 4, 2, 128, 128, 64, None, torch.float32, True),
    (1, 8, 8, 256, 256, 128, None, torch.float32, True),
    (1, 4, 1, 256, 256, 64, 64, torch.float32, True),
    (2, 2, 2, 96, 96, 32, None, torch.float32, True),
    (1, 4, 2, 128, 128, 64, None, torch.bfloat16, True),
    (1, 2, 1, 64, 64, 128, 32, torch.bfloat16, True),
    (2, 4, 2, 96, 96, 64, None, torch.float32, False),
    # the bf16 tensor-core kernel: ragged L, batch, window, head dims 32 and
    # 128, non-causal with S != L, qwen2's heads at a long prompt
    (1, 14, 2, 77, 77, 64, None, torch.bfloat16, True),
    (1, 14, 2, 300, 300, 64, None, torch.bfloat16, True),
    (1, 14, 2, 511, 511, 64, None, torch.bfloat16, True),
    (2, 14, 2, 256, 256, 64, None, torch.bfloat16, True),
    (1, 14, 2, 300, 300, 64, 100, torch.bfloat16, True),
    (2, 4, 2, 200, 200, 32, None, torch.bfloat16, True),
    (1, 8, 2, 200, 200, 128, None, torch.bfloat16, True),
    (2, 4, 2, 40, 56, 64, None, torch.bfloat16, False),
    # d_head 112 (zamba2-7b's shared attention) in both kernels: its heads
    # at a long prompt, GQA, windows, ragged edges, non-causal; then the
    # other architectures' heads in bf16: qwen3-4b (32, 8, 128), olmo-1b
    # (16, 16, 128), codeqwen1.5-7b (32, 32, 128), internvl2-2b (16, 8, 128)
    # at L = 320 behind its 256 patch slots, whisper-small's decoder
    # (12, 12, 64) at its 16-token prompt and a ragged one
    (1, 32, 32, 300, 300, 112, None, torch.bfloat16, True),
    (2, 8, 2, 200, 200, 112, 64, torch.bfloat16, True),
    (1, 4, 1, 77, 77, 112, None, torch.bfloat16, True),
    (2, 4, 2, 130, 130, 112, None, torch.float32, True),
    (1, 8, 2, 96, 96, 112, 40, torch.float32, True),
    (2, 4, 2, 40, 56, 112, None, torch.float32, False),
    (1, 32, 8, 300, 300, 128, None, torch.bfloat16, True),
    (1, 16, 16, 300, 300, 128, None, torch.bfloat16, True),
    (1, 32, 32, 300, 300, 128, None, torch.bfloat16, True),
    (1, 16, 8, 320, 320, 128, None, torch.bfloat16, True),
    (1, 12, 12, 16, 16, 64, None, torch.bfloat16, True),
    (1, 12, 12, 77, 77, 64, None, torch.bfloat16, True),
] + [(1, 14, 2, Lb, Lb, 64, None, torch.bfloat16, True)
     for Lb in PATH_BUCKETS + (LONG_L,)]
# (B, L, H, P, G, N, chunk): SSD_CASES of tests/test_kernels.py, mamba2-130m's
# prefills (plus a ragged L = 300 and L = 4096, 32 chunks), a ragged last
# chunk at chunk 64, and two groups at batch 2
SSD_CHECK_CASES = [
    (2, 64, 4, 16, 1, 16, 16), (1, 128, 8, 32, 2, 64, 32),
    (2, 40, 4, 8, 2, 16, 16), (1, 256, 2, 64, 1, 128, 128),
    (1, 300, 24, 64, 1, 128, 64), (2, 300, 8, 64, 2, 128, 128),
    (1, 300, 112, 64, 2, 64, 128),     # zamba2-7b's Mamba2 layers
] + [(1, L, 24, 64, 1, 128, 128) for L in PATH_BUCKETS + (300, LONG_L)]


class SmokeError(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- 1. device ----------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


# -- 2. build -----------------------------------------------------------------

def phase_build() -> dict:
    t0 = time.perf_counter()
    info = build.build_all()
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, r in info.items():
        ptxas = [l.strip() for l in r["log"].splitlines()
                 if "registers" in l or "spill" in l]
        out[name] = {"seconds": r["seconds"], "cached": r["cached"],
                     "ptxas": ptxas}
    return out


# -- 3. kernel vs plain version -------------------------------------------------

def _ddpm_inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for _ in range(3)]


def _check_ddpm(device) -> dict:
    errs, cases = [], []
    alpha, abar, btilde = DDPM_COEF
    for i, (shape, dtype) in enumerate(KERNEL_CHECK_SHAPES):
        x, e, n = _ddpm_inputs(shape, dtype, device, seed=100 + i)
        for l_rev in (0, 3):
            c1, c2, sigma = ops.ddpm_coefficients(alpha, abar, btilde, l_rev)
            out = ops.ddpm_step(x, e, n, alpha, abar, btilde, l_rev)
            expect = ref.ddpm_step_ref(x, e, n, c1, c2, sigma)
            sync(device)
            require(out.shape == x.shape and out.dtype == dtype,
                    f"ddpm_step output {out.shape} {out.dtype}")
            err = (out.float() - expect.float()).abs().max().item()
            require(err <= TOL[dtype], f"ddpm_step {shape} {dtype} "
                    f"l_rev={l_rev}: max abs err {err} > {TOL[dtype]}")
            errs.append(err)
            cases.append({"shape": list(shape), "dtype": str(dtype),
                          "l_rev": l_rev, "max_abs_err": err})
    # the last step (l_rev == 0) ignores the noise entirely
    x, e, n1 = _ddpm_inputs((4, 16), torch.float32, device, seed=7)
    n2 = torch.randn_like(n1)
    o1 = ops.ddpm_step(x, e, n1, *DDPM_COEF, 0)
    o2 = ops.ddpm_step(x, e, n2, *DDPM_COEF, 0)
    sync(device)
    require(torch.equal(o1, o2), "ddpm_step at l_rev=0 depends on noise")
    return {"max_abs_err": max(errs), "cases": cases,
            "last_step_deterministic": True}


def _check_ddpm_bwd(device) -> dict:
    """ddpm_step_bwd against its plain version at BWD_SHAPES in f32 and
    bf16, bit for bit (each output is one rounded product of g)."""
    cases = []
    for i, shape in enumerate(BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            g = _ddpm_inputs(shape, dtype, device, seed=300 + i)[0]
            for l_rev in (0, 3):
                c1, c2, _ = ops.ddpm_coefficients(*DDPM_COEF, l_rev)
                dx, de = ops.ddpm_step_bwd(g, c1, c2)
                wx, we = ref.ddpm_step_bwd_ref(g, c1, c2)
                sync(device)
                require(dx.shape == de.shape == g.shape
                        and dx.dtype == de.dtype == dtype,
                        f"ddpm_step_bwd output {dx.shape} {dx.dtype}")
                err = max((dx.float() - wx.float()).abs().max().item(),
                          (de.float() - we.float()).abs().max().item())
                require(torch.equal(dx, wx) and torch.equal(de, we),
                        f"ddpm_step_bwd {shape} {dtype} l_rev={l_rev}: not "
                        f"bit-exact (max abs err {err})")
                cases.append({"shape": list(shape), "dtype": str(dtype),
                              "l_rev": l_rev, "max_abs_err": err})
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "bit_exact": True, "cases": cases}


def _plain_step_chain(p, sched, state, x_L, noises):
    """reverse_sample(impl="step") with the plain ddpm_step, which autograd
    differentiates itself: the reference for the kernels' gradients."""
    L = sched.L
    te = time_embedding(torch.arange(1, L + 1, device=state.device),
                        p.time_dim)
    x = x_L
    for i in range(L):
        l_rev = L - 1 - i
        eps_hat = p(x, None, state, te=te[l_rev])
        c = ops.ddpm_coefficients(sched.alphas_host[l_rev],
                                  sched.alpha_bars_host[l_rev],
                                  sched.beta_tildes_host[l_rev], l_rev)
        x = ref.ddpm_step_ref(x, eps_hat, noises[i], *c)
    return torch.tanh(x)


GRAD_TOL = 2e-5     # of each gradient's largest magnitude


def _check_step_grad(device, R: int = 64) -> dict:
    """Gradients of a fixed scalar loss, sum(w * x_0), with respect to
    every denoiser parameter of the paper's actor (86 -> 128x3 -> 20,
    L = 5) at R rows: through reverse_sample(impl="step") (L ddpm_step and
    L ddpm_step_bwd launches on the card) against the plain step loop, on
    the same device with the same draws; within GRAD_TOL of each
    gradient's max."""
    c = _chain_inputs(CTRL_DIMS, 50, R, 5, "paper", device, 450)
    p = c["denoiser"].requires_grad_(True)
    w = torch.randn(R, 20, generator=torch.Generator().manual_seed(451))
    w = w.to(device)
    ops.reset_launches()
    x0 = reverse_sample(p, c["sched"], c["state"], 20, x_L=c["x_L"],
                        noises=c["noises"], impl="step")
    got = torch.autograd.grad(torch.sum(w * x0), list(p.parameters()))
    sync(device)
    launches = {k: ops.LAUNCHES[k] for k in ("ddpm_step", "ddpm_step_bwd")}
    if torch.device(device).type == "cuda":
        require(launches == {"ddpm_step": 5, "ddpm_step_bwd": 5},
                f"step-chain gradient launched {launches}")
    x0p = _plain_step_chain(p, c["sched"], c["state"], c["x_L"],
                            c["noises"])
    want = torch.autograd.grad(torch.sum(w * x0p), list(p.parameters()))
    rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(got, want))
    require(rel <= GRAD_TOL, f"step-chain gradients: {rel} of each "
            f"gradient's max apart (tolerance {GRAD_TOL})")
    p.requires_grad_(False)
    return {"R": R, "leaves": len(got), "rel_err": rel, "tol": GRAD_TOL,
            "launches": launches}


def _randn(g, *shape):
    return torch.randn(shape, generator=g)


def _flash_inputs(B, H, Hkv, L, S, D, dtype, device, seed, DV=None):
    g = torch.Generator().manual_seed(seed)
    return [t.to(device=device, dtype=dtype) for t in
            (_randn(g, B, L, H, D), _randn(g, B, S, Hkv, D),
             _randn(g, B, S, Hkv, DV or D))]


def _ssd_inputs(B, L, H, P, G, N, device, seed):
    """x, dt, A, B, C, D as tests/test_kernels.py draws them."""
    g = torch.Generator().manual_seed(seed)
    x = _randn(g, B, L, H, P)
    dt = F.softplus(_randn(g, B, L, H))
    A = -torch.exp(_randn(g, H) * 0.5)
    Bm, Cm = _randn(g, B, L, G, N), _randn(g, B, L, G, N)
    return [t.to(device) for t in (x, dt, A, Bm, Cm, torch.ones(H))]


def _allclose_err(out, expect, tol: float, what: str) -> float:
    """Max abs error; fails unless |out - expect| <= tol + tol*|expect|
    everywhere (the assert_allclose of tests/test_kernels.py)."""
    out, expect = out.float(), expect.float()
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(torch.allclose(out, expect, rtol=tol, atol=tol),
            f"{what}: outside rtol = atol = {tol}")
    return (out - expect).abs().max().item()


def _rel_err(out, expect) -> float:
    """||out - expect|| / ||expect||, in f64."""
    out, expect = out.double(), expect.double()
    return ((out - expect).norm() / expect.norm().clamp_min(1e-300)).item()


def _hold_flash(out, expect, what: str) -> dict:
    """flash_attention's output (B, L, H, D) against its plain version:
    allclose at TOL, and the relative error, over all of L and past L/2,
    within FLASH_REL_TOL (of the output's dtype)."""
    dtype = out.dtype
    err = _allclose_err(out, expect, TOL[dtype], what)
    rel = _rel_err(out, expect)
    half = out.shape[1] // 2
    rel_late = _rel_err(out[:, half:], expect[:, half:])
    require(max(rel, rel_late) <= FLASH_REL_TOL[dtype],
            f"{what}: relative error {rel}, {rel_late} past L/2 > "
            f"{FLASH_REL_TOL[dtype]}")
    return {"max_abs_err": err, "rel_err": rel, "rel_err_past_half": rel_late}


def _check_flash(device) -> dict:
    cases = []
    for i, (B, H, Hkv, L, S, D, window, dtype, causal) in enumerate(
            FLASH_CHECK_CASES):
        q, k, v = _flash_inputs(B, H, Hkv, L, S, D, dtype, device, 200 + i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        sync(device)
        require(out.shape == q.shape and out.dtype == dtype,
                f"flash_attention output {out.shape} {out.dtype}")
        shape = [B, H, Hkv, L, S, D]
        what = (f"flash_attention {shape} window={window} {dtype} "
                f"causal={causal}")
        cases.append({"B_H_Hkv_L_S_D": shape, "window": window,
                      "dtype": str(dtype), "causal": causal,
                      **_hold_flash(out, expect, what)})
    # online softmax renormalises exactly: constant V comes back unchanged
    q, k, _ = _flash_inputs(1, 2, 2, 128, 128, 64, torch.float32, device, 7)
    out = ops.flash_attention(q, k, torch.ones_like(k), causal=True)
    sync(device)
    ones_err = (out - 1.0).abs().max().item()
    require(ones_err <= 1e-5, f"flash_attention of constant V: {ones_err}")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "rel_err": max(max(c["rel_err"], c["rel_err_past_half"])
                           for c in cases),
            "cases": cases, "constant_v_max_abs_err": ones_err}


def ssd_exact(x, dt, A, Bm, Cm, D):
    """The SSM step by step in float64, no chunks: the answer that the
    kernel and the plain version (both f32, chunked) approximate.  The
    state is updated in place, S = exp(dt A) S + (dt x) B^T, and read out
    as y = S C + D x, with the decays and inputs formed for all steps at
    once (a quarter of the time of one einsum pair per step)."""
    x, dt, A, Bm, Cm, D = (t.double() for t in (x, dt, A, Bm, Cm, D))
    B, L, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = (t.repeat_interleave(rep, dim=2) for t in (Bm, Cm))
    decay = torch.exp(dt * A)[..., None, None]          # (B, L, H, 1, 1)
    u = (dt[..., None] * x)[..., None]                  # (B, L, H, P, 1)
    S = x.new_zeros((B, H, P, Bm.shape[3]))
    ys = x.new_empty((B, L, H, P, 1))
    for t in range(L):
        S.mul_(decay[:, t]).add_(u[:, t] * Bh[:, t, :, None, :])
        torch.matmul(S, Ch[:, t, :, :, None], out=ys[:, t])
    return ys[..., 0] + x * D[None, None, :, None], S


def _tol_ratio(out, exact, tol: float) -> float:
    """max |out - exact| / (tol + tol |exact|): 1 is the edge of the
    allclose tolerance."""
    return ((out.double() - exact).abs() / (tol + tol * exact.abs())) \
        .max().item()


def _hold_ssd(got, want, what: str) -> float:
    """ssd_scan's (y, final state) against its plain version's at SSD_TOL;
    the max abs error."""
    return max(_allclose_err(got[0], want[0], SSD_TOL, f"{what} y"),
               _allclose_err(got[1], want[1], SSD_TOL, f"{what} state"))


def _check_ssd(device) -> dict:
    """Kernel against plain version at SSD_TOL, and kernel against the
    exact f64 answer within the same tolerance (``kernel_vs_exact`` <= 1);
    beside it, how far the plain version lies from the exact answer."""
    cases = []
    for i, (B, L, H, P, G, N, chunk) in enumerate(SSD_CHECK_CASES):
        args = _ssd_inputs(B, L, H, P, G, N, device, 300 + i)
        y, st = ops.ssd_scan(*args, chunk=chunk)
        y_ref, st_ref = ref.ssd_scan_ref(*args, chunk=chunk)
        sync(device)
        require(y.shape == (B, L, H, P) and st.shape == (B, H, P, N),
                f"ssd_scan output {y.shape} {st.shape}")
        shape = [B, L, H, P, G, N, chunk]
        err = _hold_ssd((y, st), (y_ref, st_ref), f"ssd_scan {shape}")
        y64, st64 = ssd_exact(*args)
        exact = max(_tol_ratio(y, y64, SSD_TOL), _tol_ratio(st, st64,
                                                            SSD_TOL))
        require(exact <= 1.0, f"ssd_scan {shape}: {exact} of the tolerance "
                f"{SSD_TOL} from the exact answer")
        cases.append({"B_L_H_P_G_N_chunk": shape, "max_abs_err": err,
                      "kernel_vs_exact": exact,
                      "plain_vs_exact": max(_tol_ratio(y_ref, y64, SSD_TOL),
                                            _tol_ratio(st_ref, st64,
                                                       SSD_TOL))})
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "kernel_vs_exact": max(c["kernel_vs_exact"] for c in cases),
            "cases": cases}


def _chain_inputs(dims, S, R, L, kind, device, seed) -> dict:
    """A random MLP of widths ``dims`` (biases too), x_L, state and noises
    from ``seed`` on the CPU, moved to ``device``, and the schedule's
    tables; ``denoiser`` wraps the same MLP for the step path."""
    g = torch.Generator().manual_seed(seed)
    net = mlp_init(list(dims), g)
    with torch.no_grad():
        for b in net.b:
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
    net = net.to(device).requires_grad_(False)
    A, T = dims[-1], dims[0] - dims[-1] - S
    sched = make_schedule(L, kind=kind)
    x_L, state = _randn(g, R, A), _randn(g, R, S)
    noises = _randn(g, L, R, A)
    coef, te = chain_tables(sched, T, torch.device(device))
    return {"net": net, "x_L": x_L.to(device), "state": state.to(device),
            "noises": noises.to(device), "coef": coef, "te": te,
            "sched": sched, "denoiser": Denoiser(net, T)}


def _chain_args(c: dict) -> tuple:
    return c["net"], c["x_L"], c["state"], c["noises"], c["coef"], c["te"]


def chain_exact(net, x_L, state, noises, coef, te):
    """The same chain (same weights, draws and f32 tables) in float64:
    the answer that the kernel and the plain version approximate."""
    ws = [w.double() for w in net.w]
    bs = [b.double() for b in net.b]
    x, state, noises, coef, te = (t.double() for t in
                                  (x_L, state, noises, coef, te))
    L = coef.shape[0]
    for i in range(L):
        l_rev = L - 1 - i
        h = torch.cat([x, state, te[l_rev].expand(x.shape[0], -1)], dim=-1)
        for k, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if k < len(ws) - 1:
                h = torch.relu(h)
        c1, c2, sigma = coef[l_rev]
        x = c1 * x - c2 * h + sigma * noises[i]
    return x


# ddpm_chain_bwd cases (name, MLP widths, S, R, L, schedule): a D3PG
# update's policy chain (the actor at R = 64, eight clusters of 8 rows),
# one row, odd widths over a ragged second cluster (R = 9), CTAs with no
# column of the last layer, a ragged R over five clusters, and a long
# chain for the accumulation over steps
CHAIN_GRAD_CASES = [("train", CTRL_DIMS, 50, 64, 5, "paper"),
                    ("control_R1", CTRL_DIMS, 50, 1, 5, "paper"),
                    ("odd_widths", (53, 90, 90, 90, 30), 7, 9, 7, "paper"),
                    ("empty_slice", (25, 100, 100, 5), 4, 2, 3, "paper"),
                    ("R37", CTRL_DIMS, 50, 37, 5, "paper"),
                    ("L50", CTRL_DIMS, 50, 4, 50, "paper")]


def chain_grad_exact_tol(L: int) -> float:
    """Tolerance of the chain's f32 gradients against the exact f64 ones,
    per leaf as a share of its largest magnitude: 2e-5 per 50 steps, as
    ``chain_exact_tol`` holds x_0.  The plain f32 backward lies 1.5e-7 to
    2.9e-7 of the max from the f64 gradients at these cases (CPU), the
    kernel sums in another order (another ~1e-7), and a longer chain
    passes g through more updates; a ReLU mask that flipped between f32
    and f64 would move one row-step's term, ~1e-3 of the max."""
    return TOL[torch.float32] * max(1.0, L / 50)


def _leaf_rel(got, want) -> float:
    """The largest |got - want| of any leaf, over that leaf's max |want|."""
    return max((a.double() - b.double()).abs().max().item()
               / max(b.abs().max().item(), 1e-30)
               for a, b in zip(got, want))


def _chain_grad(c, w) -> tuple:
    """d(sum w x_0)/d(w, b) of every layer through ops.ddpm_chain with the
    MLP's leaves requiring a gradient (DdpmChain: the forward with its
    record and one ddpm_chain_bwd on the card)."""
    net = c["net"]
    leaves = list(net.w) + list(net.b)
    for t in leaves:
        t.requires_grad_(True)
    try:
        x0 = ops.ddpm_chain(*_chain_args(c))
        return torch.autograd.grad(torch.sum(w * x0), leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _exact_chain_grad(c, w) -> list:
    """The same gradients in float64: autograd through ``chain_exact``."""
    net = c["net"]
    ws = [t.detach().double().requires_grad_(True) for t in net.w]
    bs = [t.detach().double().requires_grad_(True) for t in net.b]
    x0 = chain_exact(SimpleNamespace(w=ws, b=bs), *_chain_args(c)[1:])
    return torch.autograd.grad(torch.sum(w.double() * x0), ws + bs)


def _check_chain_grad(device) -> dict:
    """ddpm_chain_bwd at every CHAIN_GRAD_CASES case: the gradients of a
    fixed loss sum(w * x_0) through DdpmChain against the plain backward
    on the same device and the kernel's record (within GRAD_TOL of each
    leaf's max), and against the exact f64 gradients (within
    ``chain_grad_exact_tol``); the record against the plain forward's (f32
    tolerance) and x_0 with a record bit for bit as without; two runs give
    the same bits; on the card exactly one ddpm_chain and one
    ddpm_chain_bwd launch per gradient."""
    cases = []
    on_card = torch.device(device).type == "cuda"
    for i, (name, dims, S, R, L, kind) in enumerate(CHAIN_GRAD_CASES):
        c = _chain_inputs(dims, S, R, L, kind, device, 600 + i)
        w = _randn(torch.Generator().manual_seed(700 + i), R, dims[-1])
        w = w.to(device)
        ops.reset_launches()
        got = _chain_grad(c, w)
        sync(device)
        launches = {k: ops.LAUNCHES[k] for k in ("ddpm_chain",
                                                  "ddpm_chain_bwd")}
        grids, clusters = ops.GRIDS["ddpm_chain_bwd"], \
            ops.CLUSTERS["ddpm_chain_bwd"]
        if on_card:
            require(launches == {"ddpm_chain": 1, "ddpm_chain_bwd": 1},
                    f"chain gradient {name} launched {launches}")
        again = _chain_grad(c, w)
        sync(device)
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        require(same_bits, f"chain gradient {name}: two runs differ")
        x0, rec = ops.ddpm_chain(*_chain_args(c), record=True)
        x0n = ops.ddpm_chain(*_chain_args(c))
        x0p, recp = ref.ddpm_chain_ref(*_chain_args(c), record=True)
        sync(device)
        require(torch.equal(x0, x0n), f"ddpm_chain {name}: x_0 with a "
                f"record differs from x_0 without one")
        rec_err = _allclose_err(rec, recp, TOL[torch.float32],
                                f"ddpm_chain {name} record")
        net = c["net"]
        want = ref.ddpm_chain_bwd_ref(net, rec, c["state"], c["coef"],
                                      c["te"], w)
        want = want[0] + want[1]
        rel = _leaf_rel(got, want)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        require(rel <= GRAD_TOL, f"ddpm_chain_bwd {name}: {rel} of a "
                f"leaf's max from the plain backward (tolerance "
                f"{GRAD_TOL})")
        exact = _exact_chain_grad(c, w)
        tol = chain_grad_exact_tol(L)
        k_exact = _leaf_rel(got, exact)
        require(k_exact <= tol, f"ddpm_chain_bwd {name}: {k_exact} of a "
                f"leaf's max from the exact f64 gradients (tolerance {tol})")
        cases.append({"case": name, "dims": list(dims), "S": S, "R": R,
                      "L": L, "plan": ops.chain_bwd_plan(dims, R)._asdict(),
                      "max_abs_err": err, "rel_err": rel, "tol": GRAD_TOL,
                      "record_max_abs_err": rec_err,
                      "exact_rel_err": k_exact, "exact_tol": tol,
                      "plain_exact_rel_err": _leaf_rel(want, exact),
                      "same_bits": same_bits, "launches": launches,
                      "grids": grids, "clusters": clusters})
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "rel_err": max(c["rel_err"] for c in cases),
            "exact_rel_err": max(c["exact_rel_err"] for c in cases),
            "cases": cases}


def _check_chain(device) -> dict:
    """ddpm_chain against its plain version (rtol = atol = 2e-5 where
    L <= 50) and both against the exact f64 chain (``kernel_vs_exact`` <=
    1 of ``chain_exact_tol``), at every case of CHAIN_CASES."""
    cases = []
    for i, (name, dims, S, R, L, kind) in enumerate(CHAIN_CASES):
        c = _chain_inputs(dims, S, R, L, kind, device, 400 + i)
        out = ops.ddpm_chain(*_chain_args(c))
        expect = ref.ddpm_chain_ref(*_chain_args(c))
        sync(device)
        require(out.shape == (R, dims[-1]) and out.dtype == torch.float32,
                f"ddpm_chain {name}: output {out.shape} {out.dtype}")
        require(bool(torch.isfinite(out).all()),
                f"ddpm_chain {name}: non-finite output")
        if L <= 50:
            err = _allclose_err(out, expect, TOL[torch.float32],
                                f"ddpm_chain {name}")
        else:
            err = (out - expect).abs().max().item()
        exact = chain_exact(*_chain_args(c))
        tol = chain_exact_tol(L)
        k_exact = _tol_ratio(out, exact, tol)
        require(k_exact <= 1.0, f"ddpm_chain {name}: {k_exact} of the "
                f"tolerance {tol} from the exact f64 chain")
        cases.append({"case": name, "dims": list(dims), "S": S, "R": R,
                      "L": L, "plan": ops.chain_plan(dims, R)._asdict(),
                      "max_abs_err": err, "exact_tol": tol,
                      "kernel_vs_exact": k_exact,
                      "plain_vs_exact": _tol_ratio(expect, exact, tol),
                      "max_abs_x0": exact.abs().max().item()})
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "kernel_vs_exact": max(c["kernel_vs_exact"] for c in cases),
            "cases": cases}


# the vector-env phase (5b): its fused learners, the shared learner's user
# counts, and a population of 4 members that differ in lr_actor and eps_end
VECTOR_B, SHARED_COUNTS = 8, (10, 8, 6, 4)
POP_MEMBERS = [PopMember(lr_actor=a, eps_end=e, name=f"a{a}_e{e}")
               for a in (1e-4, 3e-4) for e in (0.05, 0.2)]
# the learner axis on that phase's paths (name, B, R): the fused learners
# and the population's act at R = 1 and update at R = 64 (the minibatch's
# target and policy chains, and the policy gradient); STACKED_CASES checks
# and STACKED_TIMING times every one of them
STACKED_PATHS = [("fused_act", VECTOR_B, 1), ("fused_update", VECTOR_B, 64),
                 ("population_act", len(POP_MEMBERS), 1),
                 ("population_update", len(POP_MEMBERS), 64)]
# the learner axis (name, MLP widths, S, B, R, L): every STACKED_PATHS
# shape at the actor's widths, B = 3 over odd widths and a ragged second
# row block, and B = 1, which must be the single-learner kernel
STACKED_CASES = [(name, CTRL_DIMS, 50, B, R, 5)
                 for name, B, R in STACKED_PATHS] + [
                 ("ragged_B3", (53, 90, 90, 90, 30), 7, 3, 9, 7),
                 ("B1", CTRL_DIMS, 50, 1, 64, 5)]


def _stacked_inputs(dims, S, B, R, L, device, seed) -> dict:
    """B learners' chains of ``_chain_inputs`` (each its own MLP, x_L, state
    and noises, from seed + b), and their stacked forms."""
    cs = [_chain_inputs(dims, S, R, L, "paper", device, seed + b)
          for b in range(B)]
    net = stack_mlps([c["net"] for c in cs]).requires_grad_(False)
    return {"cs": cs, "net": net,
            "x_L": torch.stack([c["x_L"] for c in cs]),
            "state": torch.stack([c["state"] for c in cs]),
            "noises": torch.stack([c["noises"] for c in cs]),
            "coef": cs[0]["coef"], "te": cs[0]["te"]}


def _check_chain_stacked(device) -> dict:
    """ddpm_chain and ddpm_chain_bwd with the learner axis, at every
    STACKED_CASES case: the stacked launch against the plain stacked
    versions (2e-5; the backward within GRAD_TOL of each leaf's max), each
    learner's slice of x_0, the record and dW/db bit for bit against the
    single-learner launch on that learner's weights, and one launch of
    each kernel per stacked call, on the card; a gradient through
    DdpmChain on the stacked weights equals the direct backward."""
    cases = []
    on_card = torch.device(device).type == "cuda"
    for i, (name, dims, S, B, R, L) in enumerate(STACKED_CASES):
        c = _stacked_inputs(dims, S, B, R, L, device, 800 + 10 * i)
        args = (c["net"], c["x_L"], c["state"], c["noises"], c["coef"],
                c["te"])
        g = _randn(torch.Generator().manual_seed(900 + i), B, R,
                   dims[-1]).to(device)
        ops.reset_launches()
        x0, rec = ops.ddpm_chain(*args, record=True)
        dws, dbs = ops.ddpm_chain_bwd(c["net"], rec, c["state"], c["coef"],
                                      c["te"], g)
        sync(device)
        launches = {k: ops.LAUNCHES[k] for k in ("ddpm_chain",
                                                  "ddpm_chain_bwd")}
        if on_card:
            require(launches == {"ddpm_chain": 1, "ddpm_chain_bwd": 1},
                    f"stacked chain {name} launched {launches}")
        x0p, recp = ref.ddpm_chain_stacked_ref(*args, record=True)
        err = _allclose_err(x0, x0p, TOL[torch.float32],
                            f"stacked ddpm_chain {name}")
        rec_err = _allclose_err(rec, recp, TOL[torch.float32],
                                f"stacked ddpm_chain {name} record")
        pw, pb = ref.ddpm_chain_bwd_stacked_ref(c["net"], rec, c["state"],
                                                c["coef"], c["te"], g)
        rel = max(_leaf_rel([a[b] for a in dws + dbs],
                            [p[b] for p in pw + pb]) for b in range(B))
        require(rel <= GRAD_TOL, f"stacked ddpm_chain_bwd {name}: {rel} of "
                f"a leaf's max from the plain stacked backward")
        bwd_err = max((a - p).abs().max().item()
                      for a, p in zip(dws + dbs, pw + pb))
        same = True
        for b, cb in enumerate(c["cs"]):
            one, rec1 = ops.ddpm_chain(*_chain_args(cb), record=True)
            w1, b1 = ops.ddpm_chain_bwd(cb["net"], rec1, cb["state"],
                                        cb["coef"], cb["te"],
                                        g[b].contiguous())
            same &= (torch.equal(x0[b], one) and torch.equal(rec[b], rec1)
                     and all(torch.equal(a[b], o) for a, o in
                             zip(dws + dbs, w1 + b1)))
        sync(device)
        require(same, f"stacked chain {name}: a learner's slice differs "
                f"from the single-learner launch on its weights")
        leaves = list(c["net"].parameters())
        for t in leaves:
            t.requires_grad_(True)
        try:
            grads = torch.autograd.grad(
                torch.sum(g * ops.ddpm_chain(*args)), leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        require(all(torch.equal(a, o) for a, o in
                    zip(grads, dws + dbs)),
                f"stacked chain {name}: DdpmChain's gradient differs from "
                f"the direct backward")
        cases.append({"case": name, "dims": list(dims), "S": S, "B": B,
                      "R": R, "L": L,
                      "plan": ops.chain_plan(dims, R)._asdict(),
                      "bwd_plan": ops.chain_bwd_plan(dims, R)._asdict(),
                      "max_abs_err": err, "record_max_abs_err": rec_err,
                      "bwd_max_abs_err": bwd_err, "bwd_rel_err": rel,
                      "learner_slices_bit_equal": same,
                      "launches": launches})
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "bwd_max_abs_err": max(c["bwd_max_abs_err"] for c in cases),
            "bwd_rel_err": max(c["bwd_rel_err"] for c in cases),
            "cases": cases}


def phase_kernel_check(device) -> dict:
    return {"phase": "kernel_check", "ddpm_step": _check_ddpm(device),
            "ddpm_step_bwd": _check_ddpm_bwd(device),
            "step_chain_grad": _check_step_grad(device),
            "ddpm_chain": _check_chain(device),
            "ddpm_chain_bwd": _check_chain_grad(device),
            "ddpm_chain_stacked": _check_chain_stacked(device),
            "flash_attention": _check_flash(device),
            "ssd_scan": _check_ssd(device)}


# -- 4. kernel timing -----------------------------------------------------------

def _time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ddpm_bound_ms(n: int, itemsize: int):
    """Least time for one update of n elements: 3 reads + 1 write over HBM
    against 5 f32 flops an element; returns (ms, "bytes"|"operations")."""
    t_bytes = 4 * n * itemsize / HBM_BYTES_PER_S
    t_ops = 5 * n / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ddpm_bwd_bound_ms(n: int, itemsize: int):
    """Least time for the backward of one update of n elements: g read
    once, dx and d(eps_hat) written once, against 2 f32 flops an
    element; returns (ms, "bytes"|"operations")."""
    t_bytes = 3 * n * itemsize / HBM_BYTES_PER_S
    t_ops = 2 * n / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(B, L, S, H, Hkv, D, itemsize: int, causal: bool = True,
                   window=None, DV=None):
    """Least time for one attention call: q, k, v read once and out written
    once over HBM against 2*(D + DV) flops (QK^T and PV; DV, v's head size,
    defaults to D) for each (query, key) pair the mask keeps, at the peak of
    the input type (bf16 tensor cores or f32 CUDA cores); returns (ms,
    "bytes"|"operations", peak name)."""
    DV = DV or D
    i = np.arange(L)
    hi = np.minimum(S - 1, i) if causal else np.full(L, S - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(L, np.int64)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    t_bytes = itemsize * (B * L * H * (D + DV) + B * S * Hkv * (D + DV)) \
        / HBM_BYTES_PER_S
    peak, name = ((BF16_FLOPS, "bf16 989 TFLOP/s") if itemsize == 2
                  else (F32_FLOPS, "f32 67 TFLOP/s"))
    t_ops = 2 * (D + DV) * B * H * pairs / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", name)


def ssd_bound_ms(B, L, H, P, G, N, chunk: int):
    """Least time for one chunked SSD in f32: x, dt, A, B, C, D read once,
    y and the state written once, against the chunked algorithm's flops
    for these lengths (per head and chunk of Qc steps: C.B and the masked
    product over the Qc(Qc+1)/2 pairs j <= i, the inter-chunk term, the
    state update and the D skip) at the f32 CUDA-core peak."""
    t_bytes = 4 * (2 * B * L * H * P + B * L * H + 2 * H + 2 * B * L * G * N
                   + B * H * P * N) / HBM_BYTES_PER_S
    Q = min(chunk, L)
    qcs = [min(Q, L - t0) for t0 in range(0, L, Q)]
    flops = B * H * sum(qc * (qc + 1) // 2 * (2 * N + 2 * P)
                        + 4 * qc * N * P + 2 * qc * P for qc in qcs)
    t_ops = flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", "f32 67 TFLOP/s")


def chain_bound_ms(dims, S: int, R: int, L: int, record: bool = False):
    """Least time for one chain in f32: the weights, x_L, state, noises and
    the two tables read once and x_0 (and with ``record`` the record)
    written once over HBM, against the kernel's flops (per row: the
    state's share of layer 0 once; per step layer 0 over the x and
    time-embedding rows, the other layers, the biases and the 5-flop
    update) at the f32 CUDA-core peak; returns (ms, "bytes"|"operations")."""
    A, T = dims[-1], dims[0] - dims[-1] - S
    ins = [A + T] + list(dims[1:-1])
    step = sum(2 * i * o + o for i, o in zip(ins, dims[1:])) + 5 * A
    flops = R * (2 * S * dims[1] + L * step)
    weights = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (weights + 2 * R * A + R * S + L * R * A + L * (3 + T)
                  + (L * R * ops.chain_record_width(dims) if record else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def chain_bwd_bound_ms(dims, S: int, R: int, L: int):
    """Least time for one chain backward in f32 from its record: the
    weights (not the biases), the record, state, g and the two tables
    read once and every dW and db written once over HBM, against the
    kernel's flops at the f32 CUDA-core peak.  Per row and step: -c2 g,
    every layer's dW (2 in out) and db (out), the transposed products of
    the layers above the first (2 in out); at every step but the last also
    the first layer's product into x (2 A dims[1]) and g's update (2 A).
    Returns (ms, "bytes"|"operations")."""
    A, T = dims[-1], dims[0] - dims[-1] - S
    pairs = list(zip(dims[:-1], dims[1:]))
    step = A + sum(2 * i * o + o for i, o in pairs) \
        + sum(2 * i * o for i, o in pairs[1:])
    flops = R * (L * step + (L - 1) * (2 * A * dims[1] + 2 * A))
    nbytes = 4 * (sum(i * o for i, o in pairs)
                  + L * R * ops.chain_record_width(dims) + R * S + R * A
                  + L * (3 + T) + sum((i + 1) * o for i, o in pairs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _graph_ms(fn, n: int) -> float:
    """Per-launch device time of ``fn``: n launches captured in one CUDA
    graph, replayed, timed with CUDA events.  Python, ctypes and the launch
    queue stay out of it, so against the back-to-back ``ms`` it shows what
    of a launch is host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _time_ms(graph.replay, 5) / n


def _grids_per_call(kernel, name: str) -> float:
    """Grids that one call of ``kernel`` started, as its C entry point
    reports them (``ops.GRIDS``)."""
    before = ops.GRIDS[name], ops.LAUNCHES[name]
    kernel()
    return (ops.GRIDS[name] - before[0]) / (ops.LAUNCHES[name] - before[1])


def _timed_turns(kernel, plain, library=None) -> dict:
    """CUDA-event ms of kernel, plain version and library call, in turns
    (plain, kernel, library, library, kernel, plain), after a warm-up; the
    launch count per measurement is set from one timed kernel run to take
    ~20 ms.  Then ``graph_ms``, the kernel's launches from a CUDA graph
    (as many as take ~10 ms back to back, 10 to 200)."""
    fns = [f for f in (kernel, plain, library) if f is not None]
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    iters = int(min(2000, max(10, 20.0 / max(_time_ms(kernel, 3), 1e-3))))
    order = [plain, kernel] + ([library] * 2 if library else []) \
        + [kernel, plain]
    t = [_time_ms(fn, iters) for fn in order]
    out = {"iters": iters, "ms": (t[1] + t[-2]) / 2, "ms_runs": [t[1], t[-2]],
           "plain_ms": (t[0] + t[-1]) / 2, "plain_ms_runs": [t[0], t[-1]],
           "library_ms": None}
    if library:
        out["library_ms"] = (t[2] + t[3]) / 2
        out["library_ms_runs"] = [t[2], t[3]]
    n_graph = int(min(200, max(10, 10.0 / max(out["ms"], 1e-3))))
    out["graph_ms"] = _graph_ms(kernel, n_graph)
    out["graph_launches"] = n_graph
    return out


def _sdpa_call(q, k, v, scale=None):
    """The library yardstick for flash_attention (timed here only; the port
    never calls it): one ``scaled_dot_product_attention`` with
    ``is_causal=True`` (and ``scale``) on the (B, H, L, D) views, with
    ``enable_gqa=True`` where this torch has it, else on K/V heads repeated
    beforehand."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       scale=scale, enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)), \
            "sdpa(is_causal=True, enable_gqa=True)"
    except TypeError:
        G = q.shape[2] // k.shape[2]
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(
            qt, kr, vr, is_causal=True, scale=scale)), \
            "sdpa(is_causal=True) on repeated K/V heads"


def _flash_timing(device) -> list:
    H, Hkv, D = QWEN_HEADS
    rows = []
    for L in PATH_BUCKETS + (LONG_L,):
        q, k, v = _flash_inputs(1, H, Hkv, L, L, D, torch.bfloat16, device,
                                seed=L)
        library, call = _sdpa_call(q, k, v)
        def kernel():
            ops.flash_attention(q, k, v, causal=True)

        t = _timed_turns(
            kernel, lambda: ref.flash_attention_ref(q, k, v, causal=True),
            library)
        bound, by, peak = flash_bound_ms(1, L, L, H, Hkv, D, 2)
        rows.append({"shape": [1, L, H, Hkv, D], "dtype": "bfloat16",
                     **t, "bound_ms": bound, "bound_by": by, "peak": peak,
                     "library_call": call,
                     "grids_per_call": _grids_per_call(kernel,
                                                       "flash_attention")})
    return rows


def _ssd_timing(device) -> list:
    H, P, G, N, chunk = MAMBA_SSD
    rows = []
    for L in PATH_BUCKETS + (LONG_L,):
        args = _ssd_inputs(1, L, H, P, G, N, device, seed=L)

        def kernel():
            ops.ssd_scan(*args, chunk=chunk)

        t = _timed_turns(kernel,
                         lambda: ref.ssd_scan_ref(*args, chunk=chunk))
        bound, by, peak = ssd_bound_ms(1, L, H, P, G, N, chunk)
        rows.append({"shape": [1, L, H, P, G, N, chunk], "dtype": "float32",
                     **t, "bound_ms": bound, "bound_by": by, "peak": peak,
                     "grids_per_call": _grids_per_call(kernel, "ssd_scan")})
    return rows


def _chain_timing(device) -> list:
    """ddpm_chain at every CHAIN_CASES shape: the kernel, its plain version
    and, as the yardstick, the step path for the same chain
    (``reverse_sample(impl="step")``: eager denoiser and one ddpm_step a
    step, plus the final tanh), in turns; ``ms_per_layer`` divides by the
    L x layers dependent layers of the chain.  For the actor's chains
    (``CTRL_DIMS``) also a row ``<case>+record``: the forward with its
    record for the backward, timed in turns with the forward without one
    (``no_record_ms``)."""
    rows = []
    for i, (name, dims, S, R, L, kind) in enumerate(CHAIN_CASES):
        c = _chain_inputs(dims, S, R, L, kind, device, 500 + i)
        args = _chain_args(c)

        def step():
            reverse_sample(c["denoiser"], c["sched"], c["state"], dims[-1],
                           x_L=c["x_L"], noises=c["noises"], impl="step")

        t = _timed_turns(lambda: ops.ddpm_chain(*args),
                         lambda: ref.ddpm_chain_ref(*args), step)
        t["step_ms"], t["step_ms_runs"] = t.pop("library_ms"), \
            t.pop("library_ms_runs")
        t["library_ms"] = None
        layers = L * (len(dims) - 1)
        bound, by = chain_bound_ms(dims, S, R, L)
        rows.append({"case": name, "shape": {"dims": list(dims), "S": S,
                                             "R": R, "L": L},
                     **t, "bound_ms": bound, "bound_by": by,
                     "peak": "f32 67 TFLOP/s",
                     "ms_per_layer": t["ms"] / layers,
                     "graph_ms_per_layer": t["graph_ms"] / layers,
                     "grids_per_call": _grids_per_call(
                         lambda: ops.ddpm_chain(*args), "ddpm_chain")})
        if dims != CTRL_DIMS:
            continue

        def with_record():
            ops.ddpm_chain(*args, record=True)

        tr = _timed_turns(with_record, lambda: ops.ddpm_chain(*args))
        bound, by = chain_bound_ms(dims, S, R, L, record=True)
        rows.append({"case": f"{name}+record", "shape": {
            "dims": list(dims), "S": S, "R": R, "L": L, "record": True},
            "iters": tr["iters"], "ms": tr["ms"], "ms_runs": tr["ms_runs"],
            "no_record_ms": tr["plain_ms"],
            "no_record_ms_runs": tr["plain_ms_runs"],
            "graph_ms": tr["graph_ms"], "graph_launches": tr["graph_launches"],
            "plain_ms": rows[-1]["plain_ms"], "library_ms": None,
            "bound_ms": bound, "bound_by": by, "peak": "f32 67 TFLOP/s",
            "grids_per_call": _grids_per_call(with_record, "ddpm_chain")})
    return rows


# ddpm_chain under both plans: the decide cells' R = 4096 (one slot's
# decision for 4096 cells) at Table 2's widths and at U = 18, L = 10's, and
# the crossover, where it was measured: the last R of the cluster plan's
# single wave and the first of the row-tiled plan, at Table 2's widths
U18_DIMS = (134, 128, 128, 128, 36)
CHAIN_PLAN_CASES = [
    ("decide_table2", CTRL_DIMS, 50, 4096, 5),
    ("decide_u18l10", U18_DIMS, 82, 4096, 10),
    ("crossover_below", CTRL_DIMS, 50, ops.CHAIN_ROW_TILED_FROM - 1, 5),
    ("crossover_at", CTRL_DIMS, 50, ops.CHAIN_ROW_TILED_FROM, 5)]


def _chain_plans_timing(device) -> list:
    """ddpm_chain at CHAIN_PLAN_CASES under both plans, the one
    ``chain_plan`` picks and the other, forced through ``ops._chain_fwd``'s
    private ``plan``: each held against the plain version (2e-5), then ms
    in turns (cluster, row-tiled, row-tiled, cluster), graph_ms, beside
    the bound."""
    rows = []
    for i, (name, dims, S, R, L) in enumerate(CHAIN_PLAN_CASES):
        c = _chain_inputs(dims, S, R, L, "paper", device, 1200 + i)
        plans = {"row_tiled": ops._row_tiled_plan(dims),
                 "cluster": ops._cluster_chain_plan(dims, R)}

        def launch(plan):
            return lambda: ops._chain_fwd(
                list(c["net"].w), list(c["net"].b), c["x_L"], c["state"],
                c["noises"], c["coef"], c["te"], False, None, plan)

        expect = ref.ddpm_chain_ref(*_chain_args(c))
        err = {k: _allclose_err(launch(p)(), expect, TOL[torch.float32],
                                f"ddpm_chain {name} {k}")
               for k, p in plans.items()}
        t = _timed_turns(launch(plans["row_tiled"]), launch(plans["cluster"]))
        bound, by = chain_bound_ms(dims, S, R, L)
        picked = ops.chain_plan(dims, R)
        rows.append({
            "case": name, "shape": {"dims": list(dims), "S": S, "R": R,
                                    "L": L},
            "picked": "row_tiled" if picked.row_tiled else "cluster",
            "row_tiled_from": ops.CHAIN_ROW_TILED_FROM, "iters": t["iters"],
            "row_tiled": {"plan": plans["row_tiled"]._asdict(),
                          "ms": t["ms"], "ms_runs": t["ms_runs"],
                          "graph_ms": t["graph_ms"],
                          "max_abs_err": err["row_tiled"]},
            "cluster": {"plan": plans["cluster"]._asdict(),
                        "ms": t["plain_ms"], "ms_runs": t["plain_ms_runs"],
                        "graph_ms": _graph_ms(launch(plans["cluster"]),
                                              t["graph_launches"]),
                        "max_abs_err": err["cluster"]},
            "graph_launches": t["graph_launches"], "bound_ms": bound,
            "bound_by": by, "peak": "f32 67 TFLOP/s"})
    return rows


# ddpm_chain_bwd timing cases at the actor's widths (L = 5): one row, a
# D3PG minibatch, and 128 clusters
CHAIN_BWD_TIMING = [("control_R1", 1), ("train", 64), ("R1024", 1024)]


def _chain_bwd_timing(device) -> list:
    """ddpm_chain_bwd at the actor's widths (L = 5) at CHAIN_BWD_TIMING's
    R: the kernel on its record and its plain version in turns, graph_ms
    and the bound; no single PyTorch call computes it (library_ms null).
    Beside it (``fwd_bwd``) the yardstick: a policy chain's forward and
    backward, ``reverse_sample`` plus ``autograd.grad`` of sum(w * x_0),
    through the chain (``DdpmChain``: one ddpm_chain with its record, one
    ddpm_chain_bwd) and through the step path (eager denoiser, L ddpm_step
    and L ddpm_step_bwd), ms in turns and graph_ms."""
    rows = []
    for i, (name, R) in enumerate(CHAIN_BWD_TIMING):
        c = _chain_inputs(CTRL_DIMS, 50, R, 5, "paper", device, 800 + i)
        w = _randn(torch.Generator().manual_seed(900 + i), R, 20).to(device)
        _, rec = ops.ddpm_chain(*_chain_args(c), record=True)
        bargs = (c["net"], rec, c["state"], c["coef"], c["te"], w)

        def kernel():
            ops.ddpm_chain_bwd(*bargs)

        t = _timed_turns(kernel, lambda: ref.ddpm_chain_bwd_ref(*bargs))
        bound, by = chain_bwd_bound_ms(CTRL_DIMS, 50, R, 5)
        p = c["denoiser"].requires_grad_(True)
        leaves = list(p.parameters())

        def fwd_bwd(impl):
            def run():
                x0 = reverse_sample(p, c["sched"], c["state"], 20,
                                    x_L=c["x_L"], noises=c["noises"],
                                    impl=impl)
                torch.autograd.grad(torch.sum(w * x0), leaves)
            return run

        fb = _timed_turns(fwd_bwd("chain"), fwd_bwd("step"))
        step_graph = _graph_ms(fwd_bwd("step"), fb["graph_launches"])
        p.requires_grad_(False)
        rows.append({"case": name, "shape": {"dims": list(CTRL_DIMS),
                                             "S": 50, "R": R, "L": 5},
                     **t, "bound_ms": bound, "bound_by": by,
                     "peak": "f32 67 TFLOP/s",
                     "plan": ops.chain_bwd_plan(CTRL_DIMS, R)._asdict(),
                     "grids_per_call": _grids_per_call(kernel,
                                                       "ddpm_chain_bwd"),
                     "fwd_bwd": {"chain_ms": fb["ms"],
                                 "chain_ms_runs": fb["ms_runs"],
                                 "chain_graph_ms": fb["graph_ms"],
                                 "step_ms": fb["plain_ms"],
                                 "step_ms_runs": fb["plain_ms_runs"],
                                 "step_graph_ms": step_graph}})
    return rows


def _ddpm_bwd_timing(device) -> list:
    """ddpm_step_bwd at BWD_SHAPES (f32): kernel, plain version and library
    call in turns, graph_ms, the bytes bound.  The library call is one
    ``torch.outer`` of (c1, -c2) with g: rows c1*g and -c2*g, one rounded
    product an element, the kernel's function."""
    c1, c2, _ = ops.ddpm_coefficients(*DDPM_COEF, 3)
    coef = torch.tensor([c1, -c2], dtype=torch.float32, device=device)
    rows = []
    for shape in BWD_SHAPES:
        g = _ddpm_inputs(shape, torch.float32, device, seed=12)[0]

        def kernel():
            ops.ddpm_step_bwd(g, c1, c2)

        t = _timed_turns(kernel, lambda: ref.ddpm_step_bwd_ref(g, c1, c2),
                         lambda: torch.outer(coef, g.view(-1)))
        bound, by = ddpm_bwd_bound_ms(g.numel(), 4)
        rows.append({"shape": list(shape), "dtype": "float32", **t,
                     "bound_ms": bound, "bound_by": by,
                     "grids_per_call": _grids_per_call(kernel,
                                                       "ddpm_step_bwd")})
    return rows


def phase_kernel_timing(device) -> dict:
    alpha, abar, btilde = DDPM_COEF
    c1, c2, sigma = ops.ddpm_coefficients(alpha, abar, btilde, 3)
    rows = []
    for shape in TIMING_SHAPES:
        x, e, n = _ddpm_inputs(shape, torch.float32, device, seed=11)
        numel = x.numel()
        iters = 200 if numel > 1 << 20 else 2000

        def kernel():
            ops.ddpm_step(x, e, n, alpha, abar, btilde, 3)

        def plain():
            ref.ddpm_step_ref(x, e, n, c1, c2, sigma)

        for fn in (kernel, plain):       # warm-up
            for _ in range(20):
                fn()
        torch.cuda.synchronize()
        p1, k1, k2, p2 = (_time_ms(plain, iters), _time_ms(kernel, iters),
                          _time_ms(kernel, iters), _time_ms(plain, iters))
        bound, by = ddpm_bound_ms(numel, 4)
        rows.append({"shape": list(shape), "dtype": "float32",
                     "iters": iters, "ms": (k1 + k2) / 2,
                     "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
                     "plain_ms_runs": [p1, p2], "bound_ms": bound,
                     "bound_by": by, "library_ms": None,
                     "graph_ms": _graph_ms(kernel, 200 if numel <= 1 << 20
                                           else 20),
                     "grids_per_call": _grids_per_call(kernel, "ddpm_step")})
    return {"phase": "kernel_timing", "ddpm_step": rows,
            "ddpm_step_bwd": _ddpm_bwd_timing(device),
            "ddpm_chain": _chain_timing(device),
            "ddpm_chain_plans": _chain_plans_timing(device),
            "ddpm_chain_bwd": _chain_bwd_timing(device),
            "stacked": _stacked_timing(device),
            "flash_attention": _flash_timing(device),
            "ssd_scan": _ssd_timing(device)}


STACKED_TIMING = [(B, R) for _, B, R in STACKED_PATHS]


def _stacked_row(name, dims, S, B, R, L, t, single, record=False,
                 bwd=False) -> dict:
    bound, by = (chain_bwd_bound_ms(dims, S, R, L) if bwd
                 else chain_bound_ms(dims, S, R, L, record=record))
    return {"case": name, "shape": {"dims": list(dims), "S": S, "B": B,
                                    "R": R, "L": L, "record": record},
            **t, "bound_ms": B * bound, "bound_by": by,
            "peak": "f32 67 TFLOP/s", **single}


def _stacked_timing(device) -> dict:
    """The chain kernels with the learner axis at STACKED_TIMING's (B, R)
    and the actor's widths (L = 5): one stacked launch, its plain stacked
    version in turns, graph_ms and the bound (B times one learner's), and
    as the yardstick (``single_x_B_ms`` in turns with the stacked launch,
    ``single_x_B_graph_ms``) the B single-learner launches it replaces;
    ddpm_chain at R = 64 also with its record (the policy chain), and
    ddpm_chain_bwd at R = 64.  No single PyTorch call computes either
    (library_ms null)."""
    dims, S, L = CTRL_DIMS, 50, 5
    fwd, bwd = [], []
    for i, (B, R) in enumerate(STACKED_TIMING):
        c = _stacked_inputs(dims, S, B, R, L, device, 1100 + 10 * i)
        args = (c["net"], c["x_L"], c["state"], c["noises"], c["coef"],
                c["te"])
        for record in ((False, True) if R > 1 else (False,)):
            def kernel(record=record):
                ops.ddpm_chain(*args, record=record)

            def singles(record=record):
                for cb in c["cs"]:
                    ops.ddpm_chain(*_chain_args(cb), record=record)

            t = _timed_turns(
                kernel, lambda record=record: ref.ddpm_chain_stacked_ref(
                    *args, record=record), singles)
            single = {"single_x_B_ms": t.pop("library_ms"),
                      "single_x_B_ms_runs": t.pop("library_ms_runs"),
                      "single_x_B_graph_ms": _graph_ms(
                          singles, t["graph_launches"]),
                      "library_ms": None,
                      "grids_per_call": _grids_per_call(kernel,
                                                        "ddpm_chain")}
            fwd.append(_stacked_row(f"B{B}_R{R}" + ("+record" if record
                                                    else ""),
                                    dims, S, B, R, L, t, single, record))
        if R == 1:
            continue
        _, rec = ops.ddpm_chain(*args, record=True)
        recs = [ops.ddpm_chain(*_chain_args(cb), record=True)[1]
                for cb in c["cs"]]
        g = _randn(torch.Generator().manual_seed(1200 + i), B, R,
                   dims[-1]).to(device)
        gs = [g[b].contiguous() for b in range(B)]
        bargs = (c["net"], rec, c["state"], c["coef"], c["te"], g)

        def kernel_b():
            ops.ddpm_chain_bwd(*bargs)

        def singles_b():
            for cb, rb, gb in zip(c["cs"], recs, gs):
                ops.ddpm_chain_bwd(cb["net"], rb, cb["state"], cb["coef"],
                                   cb["te"], gb)

        t = _timed_turns(kernel_b,
                         lambda: ref.ddpm_chain_bwd_stacked_ref(*bargs),
                         singles_b)
        single = {"single_x_B_ms": t.pop("library_ms"),
                  "single_x_B_ms_runs": t.pop("library_ms_runs"),
                  "single_x_B_graph_ms": _graph_ms(singles_b,
                                                   t["graph_launches"]),
                  "library_ms": None,
                  "plan": ops.chain_bwd_plan(dims, R)._asdict(),
                  "grids_per_call": _grids_per_call(kernel_b,
                                                    "ddpm_chain_bwd")}
        bwd.append(_stacked_row(f"B{B}_R{R}", dims, S, B, R, L, t, single,
                                bwd=True))
    return {"ddpm_chain": fwd, "ddpm_chain_bwd": bwd}


# -- 5. training ---------------------------------------------------------------

# method t2drl as benchmarks/common.py:method_cfg sets it up (copied here:
# the port imports nothing from benchmarks/)
TUNED = dict(lr_actor=1e-4, lr_critic=1e-3, lr_ddqn=1e-3)


def method_cfg(allocator: str, cacher: str, env_cfg: EnvCfg,
               episodes: int, L: int = 5) -> T2DRLCfg:
    return T2DRLCfg(env=env_cfg, allocator=allocator, cacher=cacher,
                    episodes=episodes, L=L,
                    eps_decay_episodes=max(1, int(episodes * 0.6)),
                    warmup=100, **TUNED)


def predicted_updates(cfg: T2DRLCfg, episodes: int) -> list:
    """(D3PG, DDQN) update counts of each episode by the reference's gates
    (``repro.core.t2drl._episode_core``): a slot updates when
    min(size0 + k + 1, cap) > warmup and size0 > 0 (size0: the slot buffer
    at the frame start, K writes a frame); each of the T-1 frame
    transitions added after the frames is followed by an update when the
    frame buffer then holds more than a DDQN batch."""
    e, d3, dq = cfg.env, cfg.d3pg_cfg(), cfg.ddqn_cfg()
    size = fsize = 0
    out = []
    for _ in range(episodes):
        n_d3 = n_dq = 0
        for _ in range(e.T):
            n_d3 += sum(min(size + k + 1, d3.buffer) > cfg.warmup
                        and size > 0 for k in range(e.K))
            size = min(size + e.K, d3.buffer)
        for _ in range(e.T - 1):
            fsize = min(fsize + 1, dq.buffer)
            n_dq += fsize > dq.batch
        out.append((n_d3 * cfg.updates_per_slot, n_dq))
    return out


def _learned_params(ts) -> dict:
    return {f"{slot}.{name}": [p.detach().clone()
                               for p in ts[slot][name].parameters()]
            for slot, names in (("d3pg", ("actor", "actor_t", "critic",
                                          "critic_t")),
                                ("ddqn", ("q", "q_target")))
            for name in names}


TRAIN_KERNELS = ("ddpm_chain", "ddpm_chain_bwd", "ddpm_step", "ddpm_step_bwd")


def _timed_training(cfg: T2DRLCfg, episodes: int, dev) -> dict:
    """train_t2drl with the launch counts reset just before and read just
    after, and each episode's wall time (host clock, the episode ends in
    its one host read of the stats)."""
    marks = []
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    ts, hist = train_t2drl(cfg, episodes=episodes, device=dev,
                           callback=lambda ep, st: marks.append(
                               time.perf_counter()))
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS}
    grids = dict(ops.GRIDS)
    per_ep = np.diff([t0] + marks).tolist()
    return {"ts": ts, "hist": hist, "wall_s": wall,
            "wall_s_per_episode": per_ep, "launches": launches,
            "grids": grids}


def update_launches(impl: str, L: int, n: int) -> dict:
    """The launches of n D3PG updates of the diffusion actor: the target
    chain's ddpm_chain, and the policy chain's ddpm_chain (with its
    record) and ddpm_chain_bwd for ``impl="chain"``, or its L ddpm_step
    and L ddpm_step_bwd for ``impl="step"``."""
    if impl == "chain":
        return {"ddpm_chain": 2 * n, "ddpm_chain_bwd": n, "ddpm_step": 0,
                "ddpm_step_bwd": 0}
    return {"ddpm_chain": n, "ddpm_chain_bwd": 0, "ddpm_step": L * n,
            "ddpm_step_bwd": L * n}


def _update_timing(ts, cfg: T2DRLCfg, dev, n: int = 50) -> dict:
    """n D3PG updates with the policy chain through each ``impl``
    ("chain", then "step"), each on its own copy of the trained learner,
    minibatches from its replay buffer drawn from the same seed: host ms
    per update (ending in a synchronise), the launches of the n updates
    (counts reset just before, read just after; on the card they must be
    ``update_launches``), their grids, and the losses of the last one; on
    the card also the update's device ms (the card's own events in
    torch.profiler), the device's idle share of the host-clock time, the
    device kernels (and copies or fills) per update and the eight largest
    device events.  Both impls are timed on the host clock before either
    is profiled: a profiler run leaves later launches slower on the
    host."""
    from repro_torch.agents.allocators import actor_schedule
    from repro_torch.core.d3pg import d3pg_update
    d3 = cfg.d3pg_cfg()
    sched = actor_schedule(d3)
    out, updates = {"updates": n}, {}
    for impl in ("chain", "step"):
        learner = {"state": copy.deepcopy(ts["d3pg"])}
        g = make_generator(99, dev)

        def one(impl=impl, learner=learner, g=g):
            learner["state"], m = d3pg_update(
                learner["state"], d3, sched,
                buffer_sample(ts["ebuf"], g, d3.batch), g, impl=impl)
            return m

        for _ in range(3):                       # warm-up
            one()
        sync(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(n):
            m = one()
        sync(dev)
        wall = (time.perf_counter() - t0) / n
        launches = {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS}
        if dev.type == "cuda":
            want = update_launches(impl, cfg.L, n)
            require(launches == want, f"{n} updates with impl={impl} "
                    f"launched {launches}, expected {want}")
        out[impl] = {"ms_per_update": 1e3 * wall, "launches": launches,
                     "grids": {k: ops.GRIDS[k] for k in TRAIN_KERNELS},
                     "losses": {k: v.item() for k, v in m.items()}}
        updates[impl] = one
    if dev.type == "cuda":
        for impl, one in updates.items():
            row = out[impl]
            events, kernels, all_events = device_ms_per_call(one, 20)
            busy = sum(events.values())
            row["device_ms_per_update"] = busy
            row["device_idle_share"] = 1.0 - busy / row["ms_per_update"]
            row["device_kernels_per_update"] = kernels
            row["device_events_per_update"] = all_events
            row["device_ms_top"] = dict(sorted(events.items(),
                                               key=lambda kv: -kv[1])[:8])
    return out


def device_ms_per_call(fn, n: int) -> tuple:
    """Device time of one call of ``fn``, by event name: the time of every
    event that torch.profiler records on the card over n calls (kernels,
    copies, fills), over n; and the kernels, and all such events, per
    call.  Only the card's own events count: the CPU op that launched a
    kernel carries the kernel's time as well, and summing both would count
    it twice.  The profiler's own overhead lands on the host, not in these
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    return ({e.key: e.self_device_time_total / 1e3 / n for e in device},
            (sum(e.count for e in device) - sum(e.count for e in copies))
            / n, sum(e.count for e in device) / n)


def phase_train(device, env_cfg: EnvCfg = EnvCfg(), episodes: int = 8,
                short: int = 2, eval_episodes: int = 2) -> dict:
    """Single-cell training at the paper's width: t2drl (d3pg/ddqn) for
    ``episodes`` episodes under method_cfg's settings, then export_policy
    and eval_t2drl; then ddpg/ddqn and rcars/static for ``short``
    episodes.  Requires finite stats and losses, every learned parameter
    changed, the optimizers' steps equal to the gates' update counts and,
    on the card, exact launch counts over the t2drl run: ddpm_chain
    T*K*episodes (acting) + 2 per D3PG update (the target and the policy
    chain), ddpm_chain_bwd 1 per D3PG update (the policy gradient),
    ddpm_step and ddpm_step_bwd none.  Then one D3PG update timed with
    each ``impl`` of its policy chain (``_update_timing``)."""
    dev = resolve_device(device)
    ec = env_cfg
    cfg = method_cfg("d3pg", "ddqn", ec, episodes)
    init = _learned_params(t2drl_init(make_generator(cfg.seed, dev), cfg))
    run = _timed_training(cfg, episodes, dev)
    ts, hist = run["ts"], run["hist"]
    per_episode = predicted_updates(cfg, episodes)
    n_d3, n_dq = (sum(c) for c in zip(*per_episode))
    steps = {"opt_a": ts["d3pg"]["opt_a"]["step"],
             "opt_c": ts["d3pg"]["opt_c"]["step"],
             "ddqn": ts["ddqn"]["opt"]["step"]}
    require(steps == {"opt_a": n_d3, "opt_c": n_d3, "ddqn": n_dq},
            f"optimizer steps {steps}, the gates predict {n_d3} D3PG and "
            f"{n_dq} DDQN updates")
    want = update_launches("chain", cfg.L, n_d3)
    want["ddpm_chain"] += ec.T * ec.K * episodes
    if dev.type == "cuda":
        require(run["launches"] == want, f"training launched "
                f"{run['launches']}, expected {want}")
    require(all(math.isfinite(v) for vs in hist.values() for v in vs),
            f"non-finite training stats {hist}")
    final = _learned_params(ts)
    updated = {"d3pg": n_d3 > 0, "ddqn": n_dq > 0}
    unchanged = [k for k in init if updated[k.split(".")[0]]
                 and any(torch.equal(a, b) for a, b in zip(init[k], final[k]))]
    require(not unchanged, f"learned parameters left unchanged: {unchanged}")
    upd = _update_timing(ts, cfg, dev)
    for impl in ("chain", "step"):
        require(all(math.isfinite(v) for v in upd[impl]["losses"].values()),
                f"non-finite losses {upd[impl]['losses']} (impl={impl})")
    policy = export_policy(ts, cfg)
    t1 = time.perf_counter()
    ev = eval_t2drl(policy, ts["models"], cfg, episodes=eval_episodes,
                    device=dev)
    eval_wall = time.perf_counter() - t1
    require(all(math.isfinite(v) for v in ev.values()),
            f"non-finite eval stats {ev}")
    per_ep = run["wall_s_per_episode"]
    updating = [w for w, (n, _) in zip(per_ep, per_episode)
                if n == ec.T * ec.K]
    others = {}
    for alloc, cacher in (("ddpg", "ddqn"), ("rcars", "static")):
        c = method_cfg(alloc, cacher, ec, short)
        r = _timed_training(c, short, dev)
        require(all(math.isfinite(v) for vs in r["hist"].values()
                    for v in vs), f"{alloc}/{cacher}: non-finite stats")
        if dev.type == "cuda":
            require(sum(r["launches"].values()) == 0,
                    f"{alloc}/{cacher} launched {r['launches']}")
        others[f"{alloc}/{cacher}"] = {
            "wall_s": r["wall_s"], "wall_s_per_episode":
            r["wall_s_per_episode"], "launches": r["launches"],
            "d3pg_updates": r["ts"]["d3pg"]["opt_a"]["step"],
            "last_episode": {k: v[-1] for k, v in r["hist"].items()}}
    return {"phase": "train", "env": {"U": ec.U, "M": ec.M, "T": ec.T,
                                      "K": ec.K},
            "L": cfg.L, "episodes": episodes, "settings": {
                **TUNED, "warmup": cfg.warmup,
                "eps_decay_episodes": cfg.eps_decay_episodes,
                "d3pg_batch": cfg.d3pg_cfg().batch,
                "ddqn_batch": cfg.ddqn_cfg().batch},
            "wall_s": run["wall_s"], "wall_s_per_episode": per_ep,
            "wall_s_per_updating_episode": (sum(updating) / len(updating)
                                            if updating else None),
            "d3pg_updates": n_d3, "ddqn_updates": n_dq,
            "update_timing": upd,
            "last_episode": {k: v[-1] for k, v in hist.items()},
            "launches": run["launches"], "expected_launches": want,
            "grids": {k: run["grids"][k] for k in want},
            "eval": {"episodes": eval_episodes, "wall_s": eval_wall,
                     "stats": ev},
            "short_runs": others}


# -- 5b. vector-env training --------------------------------------------------

def _timed_run(dev, fn) -> tuple:
    """``fn(callback)`` with the launch and grid counts reset just before
    and read just after; wall s in all and per episode (host clock; each
    episode ends in its one host read of the stats)."""
    marks = []
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    out = fn(lambda ep, st: marks.append(time.perf_counter()))
    sync(dev)
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall,
                 "wall_s_per_episode": np.diff([t0] + marks).tolist(),
                 "launches": {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS},
                 "grids": {k: ops.GRIDS[k] for k in TRAIN_KERNELS}}


def _finite(hist, what: str) -> None:
    require(all(np.isfinite(np.asarray(v, np.float64)).all()
                for v in hist.values()), f"{what}: non-finite stats")


def _fused_update_timing(ts, cfg: T2DRLCfg, dev, n: int = 20) -> dict:
    """n fused D3PG updates of the B learners of ``ts`` (each on its own
    minibatch from its own buffer, one stacked update) against the same
    learners updated one after another by the single-learner update: host
    ms per fused update and per B single updates (each ending in a
    synchronise), their launches (2 ddpm_chain + 1 ddpm_chain_bwd against
    3 B) and the fused update's losses; on the card also each one's device
    ms, the device's idle share of the host time and its device kernels
    per call (torch.profiler)."""
    from repro_torch.agents.allocators import actor_schedule
    from repro_torch.core.d3pg import (d3pg_learner, d3pg_update,
                                       d3pg_update_stacked)
    d3 = cfg.d3pg_cfg()
    sched = actor_schedule(d3)
    B = len(ts["ebuf"]["ptr"])
    fused_state = {"s": copy.deepcopy(ts["d3pg"])}
    looped = copy.deepcopy(ts["d3pg"])
    views = [d3pg_learner(looped, b) for b in range(B)]
    gens = [make_generator(99 + b, dev) for b in range(B)]

    def fused():
        batch = buffer_sample_stacked(ts["ebuf"], gens, d3.batch)
        fused_state["s"], m = d3pg_update_stacked(fused_state["s"], d3,
                                                  sched, batch, gens)
        return m

    def singles():
        for b in range(B):
            batch = buffer_sample(buffer_cell(ts["ebuf"], b), gens[b],
                                  d3.batch)
            views[b], _ = d3pg_update(views[b], d3, sched, batch, gens[b])

    out = {"B": B, "updates": n}
    for name, fn in (("fused", fused), ("single_x_B", singles)):
        for _ in range(3):
            fn()
        sync(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(n):
            m = fn()
        sync(dev)
        out[name] = {"ms": 1e3 * (time.perf_counter() - t0) / n,
                     "launches_per_call": {
                         k: ops.LAUNCHES[k] / n
                         for k in ("ddpm_chain", "ddpm_chain_bwd")}}
        if name == "fused":
            out["losses"] = {k: v.tolist() for k, v in m.items()}
    if dev.type == "cuda":
        require(out["fused"]["launches_per_call"] == {
            "ddpm_chain": 2, "ddpm_chain_bwd": 1},
            f"a fused update launched {out['fused']['launches_per_call']}")
        for name, fn in (("fused", fused), ("single_x_B", singles)):
            events, kernels, _ = device_ms_per_call(fn, 10)
            busy = sum(events.values())
            out[name].update(device_ms=busy,
                             device_idle_share=1.0 - busy / out[name]["ms"],
                             device_kernels=kernels)
    return out


def _env_slot_timing(dev, ec: EnvCfg, Bs=(1, VECTOR_B), n: int = 50) -> dict:
    """Host ms of one ``env_step_slot`` (with its observation) of B cells
    at once, at each B of ``Bs``: each cell makes its slot's nine draws
    from its own generator, the arithmetic runs once for all (ending in a
    synchronise)."""
    out = {}
    for B in Bs:
        gens = [make_generator(60 + b, dev) for b in range(B)]
        env = env_reset_batch(gens, ec)
        zoos = make_models_batch(gens, ec)
        b_ = torch.full((B, ec.U), 1.0 / ec.U, device=dev)
        for _ in range(3):
            env, _, _ = env_step_slot(env, ec, zoos, b_, b_)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            env, _, _ = env_step_slot(env, ec, zoos, b_, b_)
            observe(env, ec, zoos)
        sync(dev)
        out[str(B)] = 1e3 * (time.perf_counter() - t0) / n
    return out


def phase_vector(device, env_cfg: EnvCfg = EnvCfg(), episodes: int = 2,
                 B: int = VECTOR_B, shared_counts=SHARED_COUNTS,
                 members=POP_MEMBERS, eval_episodes: int = 1,
                 ga: GACfg = GACfg()) -> dict:
    """Vector-env training at the paper's width, under method_cfg's
    settings: ``train_t2drl(num_envs=B)`` with fused independent learners;
    the shared learner over ``len(shared_counts)`` cells with those user
    counts; ``train_population`` of ``members`` and its ranking; one greedy
    schrs/ddqn episode through eval_t2drl and one lockstep SCHRS
    ``batch_act`` slot over 4 cells.  Requires (episodes, B) histories of
    finite stats, the gates' update counts, every learner's actor and
    critic changed, and on the card the fused run's exact launches: one
    ddpm_chain per acting slot for all B learners and 2 + 1 a stacked
    update, whatever B.  Then one fused update at B timed against B
    single-learner updates (``_fused_update_timing``) and the env's slot
    step at 1 and B cells (``_env_slot_timing``: the per-cell draws'
    cost).  The launches of each run are counted by shape for the
    ``kernels`` line."""
    dev = resolve_device(device)
    ec = env_cfg
    slots = ec.T * ec.K
    cfg = method_cfg("d3pg", "ddqn", ec, episodes)
    n_pred = sum(n for n, _ in predicted_updates(cfg, episodes))
    init = t2drl_init_batch(cell_generators(cfg.seed, B, dev), cfg)
    init = {k: [p.detach().clone() for p in init["d3pg"][k].parameters()]
            for k in ("actor", "critic")}
    (ts, hist), run = _timed_run(dev, lambda cb: train_t2drl(
        cfg, episodes=episodes, num_envs=B, device=dev, callback=cb))
    n = ts["d3pg"]["opt_a"]["step"]
    require(n == n_pred, f"fused run: {n} updates, the gates predict "
            f"{n_pred}")
    want = {"ddpm_chain": slots * episodes + 2 * n, "ddpm_chain_bwd": n,
            "ddpm_step": 0, "ddpm_step_bwd": 0}
    if dev.type == "cuda":
        require(run["launches"] == want, f"fused run launched "
                f"{run['launches']}, expected {want}")
    require(np.asarray(hist["mean_reward"]).shape == (episodes, B),
            f"fused history {np.asarray(hist['mean_reward']).shape}")
    _finite(hist, "fused run")
    unchanged = [(k, b) for k in init for b in range(B)
                 if n and all(torch.equal(p[b], q[b]) for p, q in zip(
                     ts["d3pg"][k].parameters(), init[k]))]
    require(not unchanged, f"learners left unchanged: {unchanged}")
    upd = _fused_update_timing(ts, cfg, dev)
    require(bool(np.isfinite(np.asarray(list(upd["losses"].values()))
                             ).all()), f"fused losses {upd['losses']}")
    fused = {**run, "B": B, "d3pg_updates": n, "expected_launches": want,
             "history_shape": list(np.asarray(hist["mean_reward"]).shape),
             "last_episode_mean": {k: float(np.mean(v[-1]))
                                   for k, v in hist.items()},
             "launches_by_shape": {
                 "ddpm_chain": {f"B{B}_R1": slots * episodes,
                                f"B{B}_R64": n, f"B{B}_R64+record": n},
                 "ddpm_chain_bwd": {f"B{B}_R64": n}}}
    del ts

    Bs = len(shared_counts)
    cfg_s = dataclasses.replace(cfg, policy="shared")
    (ts, hist), run = _timed_run(dev, lambda cb: train_t2drl(
        cfg_s, episodes=episodes, num_envs=Bs, user_counts=shared_counts,
        device=dev, callback=cb))
    n_s = ts["d3pg"]["opt_a"]["step"]
    want = {"ddpm_chain": slots * episodes + 2 * n_s,
            "ddpm_chain_bwd": n_s, "ddpm_step": 0, "ddpm_step_bwd": 0}
    if dev.type == "cuda":
        require(run["launches"] == want, f"shared run launched "
                f"{run['launches']}, expected {want}")
    require(np.asarray(hist["hit_ratio"]).shape == (episodes, Bs),
            "shared history shape")
    _finite(hist, "shared run")
    rows = cfg.d3pg_cfg().batch // Bs * Bs       # the pooled minibatch
    require(rows == 64, f"the shared learner's minibatch is {rows} rows, "
            f"not the 64 the kernels line has timed")
    shared = {**run, "B": Bs, "user_counts": list(shared_counts),
              "d3pg_updates": n_s, "expected_launches": want,
              "last_episode_mean": {k: float(np.mean(v[-1]))
                                    for k, v in hist.items()},
              "launches_by_shape": {
                  "ddpm_chain": {f"control_R{Bs}": slots * episodes,
                                 f"control_R{rows}": n_s,
                                 f"control_R{rows}+record": n_s},
                  "ddpm_chain_bwd": {"train": n_s}}}
    del ts

    Bp = len(members)
    (res, groups), run = _timed_run(dev, lambda cb: train_population(
        cfg, members, episodes=episodes, eval_episodes=eval_episodes,
        device=dev))
    ranked = rank_population(res)
    for r in res:
        _finite(r["history"], f"member {r['label']}")
    n_p = sum(n for n, _ in predicted_updates(cfg, episodes))
    want = {"ddpm_chain": slots * (episodes + eval_episodes) + 2 * n_p,
            "ddpm_chain_bwd": n_p, "ddpm_step": 0, "ddpm_step_bwd": 0}
    if dev.type == "cuda":
        require(run["launches"] == want, f"population launched "
                f"{run['launches']}, expected {want}")
    population = {
        "wall_s": run["wall_s"],
        "wall_s_per_episode": run["wall_s"] / (episodes + eval_episodes),
        "launches": run["launches"], "grids": run["grids"],
        "expected_launches": want, "groups": groups,
        "ranking": [(r["label"], r["eval"]["utility"]) for r in ranked],
        "launches_by_shape": {
            "ddpm_chain": {f"B{Bp}_R1": slots * (episodes + eval_episodes),
                           f"B{Bp}_R64": n_p, f"B{Bp}_R64+record": n_p},
            "ddpm_chain_bwd": {f"B{Bp}_R64": n_p}}}

    cfg_g = dataclasses.replace(method_cfg("schrs", "ddqn", ec, 1), ga=ga)
    pol = policy_init(cfg_g, 0, dev)
    zoo = make_models(make_generator(3, dev), ec)
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    ev = eval_t2drl(pol, zoo, cfg_g, episodes=1, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    require(all(math.isfinite(v) for v in ev.values()), f"schrs eval {ev}")
    require(sum(ops.LAUNCHES.values()) == 0, "the schrs episode launched "
            f"{dict(ops.LAUNCHES)}")
    agent = make_allocator("schrs", ec, cfg_g.d3pg_cfg(), ga)
    gens = [make_generator(40 + b, dev) for b in range(4)]
    env = env_reset_batch(gens, ec)
    zoos = make_models_batch(gens, ec)
    env = env_set_cache(env, torch.stack([
        static_popular_cache(ModelParams(*(t[b] for t in zoos)), ec)
        for b in range(4)]))
    sync(dev)
    t0 = time.perf_counter()
    b_, xi = agent.batch_act({}, SlotObs(None, env, zoos),
                             make_generator(5, dev), {})
    sync(dev)
    lockstep = time.perf_counter() - t0
    for c in range(4):
        _check_simplexes(b_[c], xi[c], env_cell(env, c))
    schrs = {"eval_wall_s": wall, "ms_per_slot": 1e3 * wall / slots,
             "stats": ev, "batch_act_cells": 4,
             "batch_act_ms": 1e3 * lockstep,
             "ga": dataclasses.asdict(ga)}
    return {"phase": "vector", "env": {"U": ec.U, "M": ec.M, "T": ec.T,
                                       "K": ec.K},
            "episodes": episodes, "fused": fused, "fused_update": upd,
            "env_slot_ms": _env_slot_timing(dev, ec, (1, B)),
            "shared": shared, "population": population, "schrs": schrs}


# -- 5c. operations: classical cachers, scenarios, checkpoints, telemetry ---

# the diag/ keys of the JAX package's telemetry history with ObsCfg(
# enabled=True) for d3pg/ddqn (repro/core/t2drl.py:560-569), copied here:
# the port imports nothing of the JAX package
DIAG_KEYS = frozenset(
    ["diag/" + k for k in ("critic_loss", "actor_loss", "q_mean",
                           "td_abs_mean", "td_abs_max", "actor_grad_norm",
                           "critic_grad_norm", "denoise_mag", "updates",
                           "ebuf_size", "ebuf_fill", "fbuf_size",
                           "fbuf_fill")]
    + ["diag/ddqn_" + k for k in ("loss", "td_abs_mean", "td_abs_max",
                                  "q_mean", "q_max", "target_div",
                                  "grad_norm", "updates")])
OPS_WARMUP = 20         # D3PG updates from the third frame of episode 1


def _ops_cfg(allocator: str, cacher: str, ec: EnvCfg, episodes: int,
             warmup: int) -> T2DRLCfg:
    return dataclasses.replace(method_cfg(allocator, cacher, ec, episodes),
                               warmup=warmup)


def _shapes(B: int, slots: int, n: int, record_target: bool = False):
    """The chain kernels' launches of a run by timing case: acting (one
    chain a slot, R = 1 per learner), and per update the target chain
    (R = 64, with its record under telemetry), the policy chain with its
    record and one backward; B = 1 is the single learner's cases."""
    act, upd = ("control", "control_R64") if B == 1 else (f"B{B}_R1",
                                                         f"B{B}_R64")
    chain = {act: slots, upd + "+record": n * (2 if record_target else 1)}
    if not record_target:
        chain[upd] = n
    return {"ddpm_chain": {k: v for k, v in chain.items() if v},
            "ddpm_chain_bwd": ({"train" if B == 1 else upd: n} if n
                               else {})}


def _add_shapes(total: dict, part: dict) -> None:
    for kern, by in part.items():
        for case, n in by.items():
            by_case = total.setdefault(kern, {})
            by_case[case] = by_case.get(case, 0) + n


def _ops_run(dev, fn, shapes: dict, totals: dict) -> tuple:
    """``_timed_run`` of ``fn``, its launches checked on the card against
    ``shapes`` (per kernel, by case) and added to the phase's totals."""
    out, run = _timed_run(dev, fn)
    want = {k: sum(shapes.get(k, {}).values()) for k in TRAIN_KERNELS}
    if dev.type == "cuda":
        require(run["launches"] == want, f"launched {run['launches']}, "
                f"expected {want}")
    _add_shapes(totals["by_shape"], shapes)
    for k in ("ddpm_chain", "ddpm_chain_bwd"):
        totals["grids"][k] += run["grids"][k]
    return out, run


def _cache_checks(ts, hist, cfg: T2DRLCfg, what: str) -> dict:
    """A classical cacher's run: every frame within the storage budget
    (storage_viol 0 in every episode and cell), the final resident units
    within the integer capacity, hit ratios in [0, 1]."""
    c_units = quantize_sizes(ts["models"].c)
    units = torch.sum(cache_rho(ts["cache"]) * c_units, dim=-1)
    cap = quantize_capacity(cfg.env.C)
    viol = np.asarray(hist["storage_viol"], np.float64)
    hit = np.asarray(hist["hit_ratio"], np.float64)
    require(bool((units <= cap).all()), f"{what}: resident units "
            f"{units.tolist()} over the capacity {cap}")
    require(float(viol.max()) == 0.0, f"{what}: storage violations {viol}")
    require(bool(((hit >= 0) & (hit <= 1)).all()), f"{what}: hit {hit}")
    _finite(hist, what)
    return {"hit_ratio": hit.tolist(), "resident_units":
            units.tolist(), "capacity_units": cap}


def _replay_checks(dev, ec: EnvCfg, Bs=(1, VECTOR_B), n_time: int = 5
                   ) -> dict:
    """One frame's replay of each classical policy on the card against the
    same replay on the CPU, every state leaf bit for bit, at 1 and B
    cells, from a warmed-up state and with a quarter of the users masked;
    then host ms per frame (ending in a synchronise) and, on the card,
    the device kernels per frame and their device ms (torch.profiler)."""
    from repro_torch.agents.cachers import classical_cacher
    out = {}
    for kind in CACHE_POLICIES:
        agent = classical_cacher(kind, ec)
        for B in Bs:
            lead = (B,) if B > 1 else ()
            g = torch.Generator().manual_seed(71 + B)
            zoo = (make_models_batch([g] * B, ec) if B > 1
                   else make_models(g, ec))
            reqs = [torch.randint(0, ec.M, lead + (ec.K, ec.U), generator=g)
                    for _ in range(3)]
            mask = (torch.rand(lead + (ec.U,), generator=g) > 0.25).float()
            st = cache_state_init(ec.M, lead=lead)
            st = agent.step_frame(st, reqs[0], zoo, None)    # warm state
            want = agent.step_frame(agent.step_frame(st, reqs[1], zoo, mask),
                                    reqs[2], zoo, None)
            to = lambda x: x.to(dev)  # noqa: E731
            st_d = {k: to(v) for k, v in st.items()}
            zoo_d = ModelParams(*(to(t) for t in zoo))
            got = agent.step_frame(agent.step_frame(
                st_d, to(reqs[1]), zoo_d, to(mask)), to(reqs[2]), zoo_d,
                None)
            bad = [k for k in want if not torch.equal(got[k].cpu(),
                                                      want[k])]
            require(not bad, f"{kind} at B={B}: the card's replay differs "
                    f"from the CPU's in {bad}")

            def frame():
                return agent.step_frame(st_d, to(reqs[1]), zoo_d,
                                        to(mask))
            frame()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_time):
                frame()
            sync(dev)
            row = {"ms_per_frame": 1e3 * (time.perf_counter() - t0) / n_time,
                   "accesses_per_frame": ec.K * ec.U * B}
            if dev.type == "cuda":
                events, kernels, _ = device_ms_per_call(frame, 2)
                row["device_kernels_per_frame"] = kernels
                row["device_ms_per_frame"] = sum(events.values())
            out[f"{kind}/B{B}"] = row
    return out


def _port_leaves(tree, path: str = "") -> list:
    """Every tensor and host value of a port state or policy, by path."""
    if isinstance(tree, torch.nn.Module):
        return [(f"{path}.{n}", p.detach()) for n, p in
                tree.named_parameters()]
    if torch.is_tensor(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _port_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _same_leaves(a, b, what: str) -> int:
    la, lb = _port_leaves(a), _port_leaves(b)
    require([k for k, _ in la] == [k for k, _ in lb],
            f"{what}: the restored state has other leaves")
    bad = [k for (k, x), (_, y) in zip(la, lb)
           if (not (x.device == y.device and x.dtype == y.dtype
                    and torch.equal(x, y)) if torch.is_tensor(x)
               else x != y)]
    require(not bad, f"{what}: leaves differ after the round trip: "
            f"{bad[:5]}")
    return len(la)


def _checkpoint_checks(dev, ec: EnvCfg, episodes: int, totals: dict,
                       tmp: str, warmup: int) -> dict:
    """Train d3pg/ddqn for ``episodes``, save_train_state, load_train_state
    onto the device: every leaf equal, and a greedy episode from the
    restored policy the live one's, bit for bit (the same generator
    seed).  Then a 4-cell batched state and an ARC policy round trip."""
    cfg = _ops_cfg("d3pg", "ddqn", ec, episodes, warmup)
    n = sum(u for u, _ in predicted_updates(cfg, episodes))
    (ts, _), run = _ops_run(dev, lambda cb: train_t2drl(
        cfg, episodes=episodes, device=dev, callback=cb),
        _shapes(1, ec.T * ec.K * episodes, n), totals)
    path = str(Path(tmp) / "t2drl.ckpt")
    sync(dev)
    t0 = time.perf_counter()
    save_train_state(path, ts, meta={"allocator": "d3pg", "cacher": "ddqn"},
                     cfg=cfg)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got, meta = load_train_state(path, cfg, device=dev)
    sync(dev)
    load_ms = 1e3 * (time.perf_counter() - t0)
    require(meta == {"allocator": "d3pg", "cacher": "ddqn"}, f"meta {meta}")
    leaves = _same_leaves(got, ts, "trained state")
    evals = []
    for state in (ts, got):
        ops.reset_launches()
        evals.append(run_eval(export_policy(state, cfg), state["models"],
                              cfg, episodes=1, seed=77, device=dev))
    require(evals[0] == evals[1], f"greedy episodes differ after the round "
            f"trip: {evals}")
    cfg4 = _ops_cfg("d3pg", "lru", ec, 1, warmup)
    ts4 = t2drl_init_batch(cell_generators(5, 4, dev), cfg4)
    path4 = str(Path(tmp) / "batched.ckpt")
    save_train_state(path4, ts4, cfg=cfg4)
    got4, _ = load_train_state(path4, cfg4, device=dev)
    _same_leaves(got4, ts4, "4-cell state")
    cfg_a = _ops_cfg("rcars", "arc", ec, 1, warmup)
    (ts_a, _), _ = _ops_run(dev, lambda cb: train_t2drl(
        cfg_a, episodes=1, device=dev, callback=cb), {}, totals)
    pol = export_policy(ts_a, cfg_a)
    path_a = str(Path(tmp) / "arc_policy.ckpt")
    save_train_state(path_a, pol)
    got_a, _ = load_train_state(path_a, device=dev)
    _same_leaves(got_a, pol, "ARC policy")
    return {"episodes": episodes, "d3pg_updates": n, "leaves": leaves,
            "bytes": Path(path).stat().st_size,
            "batched_bytes": Path(path4).stat().st_size,
            "save_ms": save_ms, "load_ms": load_ms,
            "train_wall_s": run["wall_s"], "eval_stats": evals[0]}


def _telemetry_checks(dev, ec: EnvCfg, totals: dict, tmp: str,
                      warmup: int) -> dict:
    """One d3pg/ddqn training episode with ObsCfg(enabled=True) and a
    MetricWriter, then the same without telemetry from the same seed:
    the log validates, the diag/ keys are the reference's (DIAG_KEYS),
    diag/updates is the gated update count and both runs launch the same
    kernels.  On the card one diag=True update then launches ddpm_chain
    twice (the target chain with its record, read for denoise_mag, and
    the policy chain) and ddpm_chain_bwd once, with the plain chain
    versions made to raise."""
    from repro_torch.agents.allocators import actor_schedule
    from repro_torch.core.d3pg import d3pg_update
    from repro_torch.obs import MetricWriter, ObsCfg, validate_jsonl
    cfg_off = _ops_cfg("d3pg", "ddqn", ec, 1, warmup)
    cfg_on = dataclasses.replace(cfg_off, obs=ObsCfg(enabled=True))
    n = sum(u for u, _ in predicted_updates(cfg_off, 1))
    slots = ec.T * ec.K
    log = str(Path(tmp) / "telemetry.jsonl")
    with MetricWriter(log) as w:
        (ts, hist), on = _ops_run(dev, lambda cb: train_t2drl(
            cfg_on, episodes=1, device=dev, callback=cb, writer=w),
            _shapes(1, slots, n, record_target=True), totals)
        eval_t2drl(export_policy(ts, cfg_on), ts["models"], cfg_on,
                   episodes=1, device=dev, writer=w)
    (ts_off, hist_off), off = _ops_run(dev, lambda cb: train_t2drl(
        cfg_off, episodes=1, device=dev, callback=cb),
        _shapes(1, slots, n), totals)
    records = validate_jsonl(log)
    kinds = [json.loads(line)["kind"] for line in open(log)]
    require(kinds == ["manifest", "train_chunk", "eval"], f"log {kinds}")
    diag = {k for k in hist if k.startswith("diag/")}
    require(diag == DIAG_KEYS, f"diag keys {sorted(diag ^ DIAG_KEYS)} "
            "differ from the reference's")
    require(hist["diag/updates"] == [float(n)] == [float(
        ts["d3pg"]["opt_a"]["step"])], f"diag/updates {hist['diag/updates']}"
        f", {n} gated updates")
    mag = hist["diag/denoise_mag"][0]
    require(len(mag) == cfg_on.L and all(math.isfinite(v) and v > 0
                                         for v in mag), f"denoise_mag {mag}")
    require(sum(on["launches"].values()) == sum(off["launches"].values()),
            f"telemetry changed the launches: {on['launches']} against "
            f"{off['launches']}")
    tap = None
    if dev.type == "cuda":
        d3 = cfg_on.d3pg_cfg()
        g = make_generator(5, dev)
        saved = (ref.ddpm_chain_ref, ref.ddpm_chain_stacked_ref)

        def refuse(*a, **k):
            raise SmokeError("the plain chain ran on the card")
        ref.ddpm_chain_ref = ref.ddpm_chain_stacked_ref = refuse
        try:
            ops.reset_launches()
            _, m = d3pg_update(ts["d3pg"], d3, actor_schedule(d3),
                               buffer_sample(ts["ebuf"], g, d3.batch), g,
                               diag=True)
            sync(dev)
        finally:
            ref.ddpm_chain_ref, ref.ddpm_chain_stacked_ref = saved
        tap = {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS}
        require(tap == update_launches("chain", cfg_on.L, 1),
                f"a diag=True update launched {tap}")
        require(m["denoise_mag"].shape == (cfg_on.L,)
                and bool(torch.isfinite(m["denoise_mag"]).all()),
                f"denoise_mag {m['denoise_mag']}")
    return {"records": records, "record_kinds": kinds,
            "diag_keys": len(diag), "diag_updates": hist["diag/updates"][0],
            "denoise_mag": mag, "wall_s_on": on["wall_s"],
            "wall_s_off": off["wall_s"], "launches_on": on["launches"],
            "launches_off": off["launches"], "diag_update_launches": tap}


def phase_ops(device, env_cfg: EnvCfg = EnvCfg(), B: int = VECTOR_B,
              scenario_B: int = 4, warmup: int = OPS_WARMUP,
              card=None, ckpt_dir=None) -> dict:
    """The operations slice at the paper's EnvCfg() with method_cfg's
    settings but ``warmup`` (so every one-episode run updates):

    - classical cachers: one d3pg training episode with each of lru, lfu,
      lru-ghost and arc on one cell, two episodes of B fused cells with
      arc (each frame within the storage budget, the resident units
      within the capacity, hit ratios in [0, 1]); one frame's replay of
      each on the card against the CPU's, bit for bit, at 1 and B cells,
      with its ms and device kernels per frame;
    - scenarios: every built-in for one training episode and one greedy
      eval episode, hetero-cells and degraded-channel at ``scenario_B``
      fused cells; paper-default the unmodulated run bit for bit;
    - checkpoints (``_checkpoint_checks``) and telemetry
      (``_telemetry_checks``).

    Every training run's launches are checked on the card and counted by
    shape for the ``kernels`` line; ``card`` is nvidia-smi's name and
    power limit, printed beside the numbers.  The checkpoints go to
    ``ckpt_dir`` (kept for the fleet phase) or to a temporary directory."""
    from repro_torch.scenarios import build_scenario, list_scenarios
    dev = resolve_device(device)
    ec = env_cfg
    slots = ec.T * ec.K
    totals = {"by_shape": {"ddpm_chain": {}, "ddpm_chain_bwd": {}},
              "grids": {"ddpm_chain": 0, "ddpm_chain_bwd": 0}}
    cachers = {}
    for kind in CACHE_POLICIES:
        cfg = _ops_cfg("d3pg", kind, ec, 1, warmup)
        n = sum(u for u, _ in predicted_updates(cfg, 1))
        (ts, hist), run = _ops_run(dev, lambda cb: train_t2drl(
            cfg, episodes=1, device=dev, callback=cb),
            _shapes(1, slots, n), totals)
        require(ts["d3pg"]["opt_a"]["step"] == n > 0,
                f"{kind}: {ts['d3pg']['opt_a']['step']} updates, expected "
                f"{n}")
        cachers[kind] = {"s_per_episode": run["wall_s"], "d3pg_updates": n,
                         **_cache_checks(ts, hist, cfg, kind)}
    cfg = _ops_cfg("d3pg", "arc", ec, 2, warmup)
    n = sum(u for u, _ in predicted_updates(cfg, 2))
    (ts, hist), run = _ops_run(dev, lambda cb: train_t2drl(
        cfg, episodes=2, num_envs=B, device=dev, callback=cb),
        _shapes(B, 2 * slots, n), totals)
    cachers[f"arc_fused_B{B}"] = {
        "s_per_episode": run["wall_s_per_episode"], "d3pg_updates": n,
        **_cache_checks(ts, hist, cfg, f"arc at B={B}")}
    del ts
    replay = _replay_checks(dev, ec, (1, B))

    scen = {}
    for name in list_scenarios():
        Bn = scenario_B if name in ("hetero-cells",
                                    "degraded-channel") else 1
        b = build_scenario(name, ec, Bn, device=dev)
        cfg = _ops_cfg("d3pg", "ddqn", b.env, 1, warmup)
        n = sum(u for u, _ in predicted_updates(cfg, 1))
        (ts, hist), run = _ops_run(dev, lambda cb: train_t2drl(
            cfg, episodes=1, num_envs=Bn, user_counts=b.user_counts,
            mods=b.mods, device=dev, callback=cb),
            _shapes(Bn, slots, n), totals)
        _finite(hist, name)
        t0 = time.perf_counter()
        if Bn == 1:
            ops.reset_launches()
            ev = eval_t2drl(export_policy(ts, cfg), ts["models"], cfg,
                            episodes=1, device=dev, mods=b.mods,
                            user_counts=b.user_counts)
            require(dev.type != "cuda" or ops.LAUNCHES["ddpm_chain"]
                    == slots, f"{name}: greedy episode launched "
                    f"{dict(ops.LAUNCHES)}")
        else:
            masks = (None if b.user_counts is None else
                     make_user_masks(b.env, b.user_counts).to(dev))
            ops.reset_launches()
            ev = {k: float(np.mean(v)) for k, v in run_eval_batch(
                ts, cfg, episodes=1, mods=b.mods, masks=masks,
                device=dev).items()}
        eval_s = time.perf_counter() - t0
        require(all(math.isfinite(v) for v in ev.values()),
                f"{name}: eval {ev}")
        scen[name] = {"cells": Bn, "modulated": b.mods is not None,
                      "s_per_episode": run["wall_s"], "eval_s": eval_s,
                      "d3pg_updates": n, "eval": ev}
        if name == "paper-default":
            require(b.mods is None, "paper-default built a schedule")
            (ts_ref, hist_ref), _ = _ops_run(dev, lambda cb: train_t2drl(
                cfg, episodes=1, device=dev, callback=cb),
                _shapes(1, slots, n), totals)
            require(hist_ref == hist, "paper-default differs from mods=None")
            _same_leaves(ts_ref, ts, "paper-default state")
        del ts
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = _checkpoint_checks(dev, ec, 2, totals, ckpt_dir or tmp,
                                  warmup)
        tel = _telemetry_checks(dev, ec, totals, tmp, warmup)
    return {"phase": "ops", "card": card,
            "env": {"U": ec.U, "M": ec.M, "T": ec.T, "K": ec.K},
            "warmup": warmup, "cachers": cachers, "replay": replay,
            "scenarios": scen, "checkpoint": ckpt, "telemetry": tel,
            "launches_by_shape": totals["by_shape"],
            "grids": totals["grids"]}


# -- 6. control plane -----------------------------------------------------------

def _plain_chain(p, sched, state, x_L, noises):
    """The reverse chain with the plain ddpm_step (no kernel), no
    gradient: the reference for the sampler on the card."""
    with torch.no_grad():
        return _plain_step_chain(p, sched, state, x_L, noises)


def _check_simplexes(b, xi, env) -> None:
    gate = env.rho[env.req]
    require(bool(torch.all(b >= 0)) and abs(b.sum().item() - 1.0) < 1e-5,
            f"b is off the simplex: {b.tolist()}")
    require(bool(torch.all(xi >= 0)) and bool(torch.all(xi[gate == 0] == 0)),
            f"xi is not cache-gated: {xi.tolist()} gate {gate.tolist()}")
    want = 1.0 if bool(torch.any(gate > 0)) else 0.0
    require(abs(xi.sum().item() - want) < 1e-5,
            f"xi sums to {xi.sum().item()}, expected {want}")


def _episode_actions(policy, cfg: T2DRLCfg, models, dev, seed: int,
                     impl: str):
    """One greedy episode slot by slot, as ``greedy_episode`` runs it, with
    the actor's chain through ``impl``: the (T*K, 2U) actions [b, xi]."""
    ec = cfg.env
    g = make_generator(seed, dev)
    env = env_reset(g, ec)
    actions = []
    for _ in range(ec.T):
        env = env_advance_frame(env, ec)
        env = env_set_cache(env, greedy_frame_cache(policy, cfg, models,
                                                    env.gamma_idx, g))
        for _ in range(ec.K):
            b, xi = greedy_slot_action(policy, cfg, env, models, g,
                                       impl=impl)
            actions.append(torch.cat([b, xi]))
            env, _, _ = env_step_slot(env, ec, models, b, xi)
    return torch.stack(actions)


def _chain_vs_step_episode(policy, cfg: T2DRLCfg, models, dev) -> dict:
    """The same greedy episode (same seed, same draws) with the default
    chain and with ``impl="step"``: one ddpm_chain a slot against L
    ddpm_step a slot, and the same actions to the f32 tolerance."""
    ec = cfg.env
    out = {}
    for impl in ("chain", "step"):
        ops.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        acts = _episode_actions(policy, cfg, models, dev, 7, impl)
        sync(dev)
        out[impl] = {"wall_s": time.perf_counter() - t0,
                     "launches": {k: ops.LAUNCHES[k]
                                  for k in ("ddpm_chain", "ddpm_step")},
                     "grids": ops.GRIDS["ddpm_step"], "actions": acts}
    want = {"chain": {"ddpm_chain": ec.T * ec.K, "ddpm_step": 0},
            "step": {"ddpm_chain": 0, "ddpm_step": cfg.L * ec.T * ec.K}}
    if dev.type == "cuda":
        for impl in want:
            require(out[impl]["launches"] == want[impl],
                    f"greedy episode, impl={impl}: launches "
                    f"{out[impl]['launches']}, expected {want[impl]}")
    err = (out["chain"]["actions"] - out["step"]["actions"]).abs().max() \
        .item()
    require(err <= TOL[torch.float32],
            f"greedy episode chain vs step: actions differ by {err}")
    return {impl: {k: v for k, v in out[impl].items() if k != "actions"}
            for impl in out} | {"slots": ec.T * ec.K,
                                 "actions_max_abs_diff": err}


def phase_control_plane(device, env_cfg: EnvCfg = EnvCfg(),
                        episodes: int = 3) -> dict:
    dev = resolve_device(device)
    cfg = T2DRLCfg(env=env_cfg)
    models = make_models(make_generator(1, dev), env_cfg)
    policy = policy_init(cfg, seed=0, device=dev)
    per_episode = env_cfg.T * env_cfg.K          # one chain per slot

    # the serving path: counts reset just before, read just after
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    hist = run_eval(policy, models, cfg, episodes=episodes, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("ddpm_chain", "ddpm_step")}
    grids, clusters = ops.GRIDS["ddpm_chain"], ops.CLUSTERS["ddpm_chain"]
    base_cfg = T2DRLCfg(env=env_cfg, allocator="rcars", cacher="random")
    ops.reset_launches()
    t1 = time.perf_counter()
    base = run_eval({}, models, base_cfg, episodes=1, device=dev)
    sync(dev)
    base_wall = time.perf_counter() - t1
    base_launches = sum(ops.LAUNCHES.values())

    for name, h in (("d3pg/ddqn", hist), ("rcars/random", base)):
        require(all(math.isfinite(v) for vs in h.values() for v in vs),
                f"{name}: non-finite episode stats {h}")
    if dev.type == "cuda":
        require(launches == {"ddpm_chain": per_episode * episodes,
                             "ddpm_step": 0},
                f"{episodes} d3pg episodes launched {launches}, expected "
                f"{per_episode * episodes} ddpm_chain and no ddpm_step")
        require(base_launches == 0, f"rcars launched {base_launches} "
                f"kernels")

    # simplexes over one frame, and one slot through kernel vs plain chain
    g = make_generator(5, dev)
    env = env_advance_frame(env_reset(g, env_cfg), env_cfg)
    env = env_set_cache(env, greedy_frame_cache(policy, cfg, models,
                                                env.gamma_idx))
    for _ in range(env_cfg.K):
        b, xi = greedy_slot_action(policy, cfg, env, models, g)
        _check_simplexes(b, xi, env)
        env, _, _ = env_step_slot(env, env_cfg, models, b, xi)
    d3 = cfg.d3pg_cfg()
    A = env_cfg.action_dim
    x_L = torch.randn(A, generator=g, device=dev)
    noises = torch.randn((cfg.L, A), generator=g, device=dev)
    b1, xi1 = greedy_slot_action(policy, cfg, env, models, x_L=x_L,
                                 noises=noises)
    raw = 0.5 * (_plain_chain(policy["actor"], make_actor_schedule(d3),
                              observe(env, env_cfg, models), x_L, noises)
                 + 1.0)
    b2, xi2 = amend_actions(raw, env.req, env.rho, env_cfg.U)
    slot_err = max((b1 - b2).abs().max().item(),
                   (xi1 - xi2).abs().max().item())
    require(slot_err <= TOL[torch.float32],
            f"greedy slot action kernel vs plain: max abs err {slot_err}")
    means = {k: sum(hist[k]) / len(hist[k]) for k in STAT_KEYS}
    return {"phase": "control_plane", "env": {"U": env_cfg.U, "M": env_cfg.M,
                                              "T": env_cfg.T, "K": env_cfg.K},
            "episodes": episodes, "wall_s": wall,
            "wall_s_per_episode": wall / episodes, "stats": means,
            "launches": launches, "grids": grids, "clusters": clusters,
            "expected_launches": per_episode * episodes,
            "rcars_random": {"wall_s": base_wall,
                             "stats": {k: base[k][0] for k in STAT_KEYS},
                             "launches": base_launches},
            "slot_kernel_vs_plain_max_abs_err": slot_err,
            "chain_vs_step_episode": _chain_vs_step_episode(policy, cfg,
                                                            models, dev)}


# -- 7. data plane --------------------------------------------------------------

def phase_data_plane(device, env_cfg: EnvCfg = EnvCfg(T=3, K=4),
                     image_dim: int = 256, total_steps: int = 1000) -> dict:
    dev = resolve_device(device)
    cfg = T2DRLCfg(env=env_cfg)
    models = make_models(make_generator(2, dev), env_cfg)
    policy = policy_init(cfg, seed=0, device=dev)
    host = {f: getattr(models, f).tolist()
            for f in ("c", "a1", "a2", "a3", "a4", "b1", "b2")}
    catalogue = [CatalogEntry(
        model_id=m, name=f"diffusion-{m}", kind="diffusion",
        size_gb=host["c"][m], builder=toy_diffusion_builder(m, image_dim),
        a1=host["a1"][m], a2=host["a2"][m], a3=host["a3"][m],
        a4=host["a4"][m], b1=host["b1"][m], b2=host["b2"][m])
        for m in range(env_cfg.M)]
    gw = EdgeGateway(catalogue, capacity_gb=env_cfg.C, image_dim=image_dim,
                     total_steps=total_steps, device=dev)
    g = make_generator(3, dev)
    env = env_reset(g, env_cfg)

    slots, frames, steps_run, images = [], [], 0, 0
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    for t in range(env_cfg.T):
        env = env_advance_frame(env, env_cfg)
        rho = greedy_frame_cache(policy, cfg, models, env.gamma_idx)
        env = env_set_cache(env, rho)
        info = gw.apply_caching(rho.cpu().numpy())
        frames.append({"frame": t, "gamma": int(env.gamma_idx),
                       "loaded": sorted(gw.loaded), **info})
        for k in range(env_cfg.K):
            sync(dev)
            ts = time.perf_counter()
            b, xi = greedy_slot_action(policy, cfg, env, models, g)
            results = gw.serve_slot(env.req.tolist(), xi.cpu().numpy(), g)
            env, r, m = env_step_slot(env, env_cfg, models, b, xi)
            r = r.item()
            slot_wall = time.perf_counter() - ts
            served = [x for x in results if x.cached]
            steps_run += sum(x.steps for x in served)
            images += len(served)
            require(all(x.output_shape == (image_dim,) for x in served),
                    "gateway output shape")
            slots.append({
                "frame": t, "slot": k, "reward": r,
                "edge_served": len(served), "users": env_cfg.U,
                "steps": sum(x.steps for x in served),
                "measured_exec_s": sum(x.measured_wall_s for x in results),
                "modeled_delay_s": sum(x.modeled_delay for x in results),
                "slot_wall_s": slot_wall})
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("ddpm_chain", "ddpm_step")}
    grids, clusters = ops.GRIDS["ddpm_chain"], ops.CLUSTERS["ddpm_chain"]
    expected = {"ddpm_chain": env_cfg.T * env_cfg.K + images,
                "ddpm_step": 0}
    if dev.type == "cuda":
        require(launches == expected,
                f"data plane launched {launches}, expected {expected} (one "
                f"ddpm_chain per slot for the actor, one per served image)")
    require(all(math.isfinite(s["reward"]) for s in slots),
            "non-finite slot reward")

    # one image chain of a loaded model: kernel vs plain on the same draws
    loaded = sorted(gw.loaded)
    chain_err = None
    if loaded:
        n_steps = min(total_steps, 50)
        x_L = torch.randn(image_dim, generator=g, device=dev)
        noises = torch.randn((n_steps, image_dim), generator=g, device=dev)
        out = gw.diffusion_sample(loaded[0], n_steps, x_L=x_L, noises=noises)
        expect = _plain_chain(gw.loaded[loaded[0]], gw._schedule(n_steps),
                              gw._state, x_L, noises)
        require(bool(torch.all(torch.isfinite(out)))
                and float(out.abs().max()) <= 1.0, "image chain output")
        chain_err = (out - expect).abs().max().item()
        require(chain_err <= TOL[torch.float32],
                f"image chain kernel vs plain: max abs err {chain_err}")
    return {"phase": "data_plane", "image_dim": image_dim,
            "total_steps": total_steps, "frames": frames, "slots": slots,
            "wall_s": wall, "image_steps": steps_run, "images": images,
            "launches": launches, "grids": grids, "clusters": clusters,
            "expected_launches": expected,
            "ms_per_image_step": 1e3 * sum(s["measured_exec_s"]
                                           for s in slots)
            / max(steps_run, 1),
            "measured_exec_s": sum(s["measured_exec_s"] for s in slots),
            "modeled_delay_s": sum(s["modeled_delay_s"] for s in slots),
            "image_chain_kernel_vs_plain_max_abs_err": chain_err}


# -- 8. LM plane ----------------------------------------------------------------

LM_MODELS = {1: "qwen2-0.5b", 2: "mamba2-130m"}    # gateway model ids
LM_KERNEL = {"qwen2-0.5b": "flash_attention", "mamba2-130m": "ssd_scan"}
# kernel vs plain prefill: the two paths round the same bf16 activations,
# but the kernels sum in another order than the plain versions, so a bf16
# rounding may move by one ulp (2^-8 relative) in any of the 24 layers;
# the last-token logits may differ by 5% of their largest magnitude
LM_PREFILL_TOL = 5e-2


class _FiniteLogits:
    """Records whether every logit the engines produce is finite: wraps
    the engine module's ``lm_prefill``/``lm_decode`` for the duration,
    keeping one device flag per call (no extra synchronisation)."""

    def __enter__(self):
        self.flags = []
        self._saved = (engine_mod.lm_prefill, engine_mod.lm_decode)

        def watch(fn):
            def wrapped(*a, **kw):
                logits, cache = fn(*a, **kw)
                self.flags.append(torch.isfinite(logits).all())
                return logits, cache
            return wrapped
        engine_mod.lm_prefill, engine_mod.lm_decode = map(watch, self._saved)
        return self

    def __exit__(self, *exc):
        engine_mod.lm_prefill, engine_mod.lm_decode = self._saved

    def all_finite(self) -> bool:
        return bool(torch.stack(self.flags).all()) if self.flags else True


def _lm_catalogue(dev, make: str, max_seq: int, image_dim: int):
    def lm_builder(arch_name, seed):
        def build():
            cfg = getattr(get_arch(arch_name), make)()
            params = lm_mod.lm_init(make_generator(seed, dev), cfg)
            return Engine(cfg, params, ServeCfg(max_batch=4, max_seq=max_seq),
                          device=dev)
        return build
    cat = [CatalogEntry(model_id=0, name="diffusion-0", kind="diffusion",
                        size_gb=0.5, builder=toy_diffusion_builder(0,
                                                                   image_dim))]
    for m, name in LM_MODELS.items():
        cat.append(CatalogEntry(model_id=m, name=name, kind="lm",
                                size_gb=2.0, builder=lm_builder(name, m)))
    return cat


def _generated(prompt_len: int, budget: int, max_seq: int) -> int:
    """Tokens an engine request yields: the prefill's, then decode steps
    until the budget is spent or the position reaches max_seq - 1 (at
    least one step), counting from the prompt's bucket."""
    Lb = min(_bucket(prompt_len), max_seq)
    return 1 + max(1, min(budget, max_seq - 1 - Lb))


def _prefill_kernel_vs_plain(engine: Engine, prompt) -> dict:
    """Last-token logits of one prefill through the kernels and through
    the plain versions, on the same padded tokens and a fresh cache."""
    Lb = min(_bucket(len(prompt)), engine.sc.max_seq)
    toks = np.full((1, Lb), engine.sc.pad_id, np.int64)
    toks[0, :len(prompt)] = prompt
    toks = torch.from_numpy(toks).to(engine.device)
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "plain"):
            cache = lm_mod.lm_init_cache(engine.cfg, 1, engine.sc.max_seq,
                                         device=engine.device)
            out[impl] = lm_mod.lm_prefill(engine.params, engine.cfg, toks,
                                          cache, impl=impl)[0].float()
    scale = out["plain"].abs().max().item()
    err = (out["kernel"] - out["plain"]).abs().max().item()
    require(bool(torch.isfinite(out["kernel"]).all())
            and bool(torch.isfinite(out["plain"]).all()),
            f"{engine.cfg.name}: non-finite prefill logits")
    require(err <= LM_PREFILL_TOL * scale,
            f"{engine.cfg.name}: prefill logits kernel vs plain differ by "
            f"{err} > {LM_PREFILL_TOL} x {scale}")
    return {"bucket": Lb, "max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "tolerance_rel": LM_PREFILL_TOL,
            "same_argmax": bool(out["kernel"].argmax() == out["plain"]
                                .argmax())}


def phase_lm_plane(device, make: str = "make_full", n_requests: int = 8,
                   max_prompt: int = 300, max_seq: int = 512,
                   max_new: int = 16, slots: int = 3, users: int = 4,
                   total_steps: int = 1000, image_dim: int = 256,
                   seed: int = 0) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gw = EdgeGateway(_lm_catalogue(dev, make, max_seq, image_dim),
                     capacity_gb=8.0, image_dim=image_dim,
                     total_steps=total_steps, device=dev)
    load = gw.apply_caching(np.ones(1 + len(LM_MODELS)))
    require(sorted(gw.loaded) == [0, *LM_MODELS], f"loaded {gw.loaded}")
    engines = {name: gw.loaded[m] for m, name in LM_MODELS.items()}
    n_layers = {name: e.cfg.n_layers for name, e in engines.items()}
    g = make_generator(seed, dev)

    def launches():
        return {k: ops.LAUNCHES[k] for k in ("flash_attention", "ssd_scan",
                                             "ddpm_chain", "ddpm_step")}

    def grids():
        return dict(ops.GRIDS)

    def expect(prefills: dict) -> dict:
        return {LM_KERNEL[n]: n_layers[n] * prefills.get(n, 0)
                for n in engines}

    # gateway slots: each cached LM request is one prefill of an 8-token
    # prompt and max(1, steps // 16) tokens
    slot_rows, served = [], {n: 0 for n in engines}
    buckets = {n: [] for n in engines}
    with _FiniteLogits() as fin:
        ops.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        for k in range(slots):
            req = rng.integers(0, 1 + len(LM_MODELS), size=users)
            xi = rng.dirichlet(np.ones(users))
            res = gw.serve_slot(req.tolist(), xi, g)
            for r in res:
                if r.model_id in LM_MODELS:
                    name = LM_MODELS[r.model_id]
                    served[name] += 1
                    buckets[name].append(8)
                    want = _generated(8, max(1, r.steps // 16), max_seq)
                    require(r.output_shape == (want,),
                            f"{name}: gateway output {r.output_shape}, "
                            f"expected ({want},)")
            slot_rows.append({"slot": k, "requests": req.tolist(),
                              "xi": xi.tolist(),
                              "steps": [r.steps for r in res],
                              "measured_wall_s": [r.measured_wall_s
                                                  for r in res]})
        sync(dev)
        gw_wall = time.perf_counter() - t0
        gw_launches, gw_grids = launches(), grids()
        finite = fin.all_finite()
    require(finite, "non-finite logits in the gateway's LM requests")
    images = sum(m == 0 for row in slot_rows for m in row["requests"])
    if dev.type == "cuda":
        for kname, n in expect(served).items():
            require(gw_launches[kname] == n, f"gateway: {kname} launched "
                    f"{gw_launches[kname]} times, expected {n}")
        require(gw_launches["ddpm_chain"] == images
                and gw_launches["ddpm_step"] == 0,
                f"gateway: {gw_launches['ddpm_chain']} ddpm_chain and "
                f"{gw_launches['ddpm_step']} ddpm_step launches, expected "
                f"{images} (one per image) and 0")

    # one Engine.run per model: prompts of 4..max_prompt tokens from seed
    runs = {}
    for name, eng in engines.items():
        vocab = eng.cfg.vocab
        reqs = [(i, rng.integers(0, vocab, size=int(rng.integers(
            4, max_prompt + 1))), int(rng.integers(4, max_new + 1)))
            for i in range(n_requests)]
        buckets[name] += [min(_bucket(len(p)), max_seq) for _, p, _ in reqs]
        with _FiniteLogits() as fin:
            ops.reset_launches()
            sync(dev)
            done, stats = eng.run(reqs)
            sync(dev)
            got, got_grids = launches(), grids()
            finite = fin.all_finite()
        require(finite, f"{name}: non-finite logits in Engine.run")
        require(sorted(done) == list(range(n_requests)) and all(
            len(done[i]) == _generated(len(p), mnt, max_seq)
            for i, p, mnt in reqs),
            f"{name}: generated lengths {[len(v) for v in done.values()]}")
        want = expect({name: stats["prefills"]})
        other = [k for k in ("flash_attention", "ssd_scan")
                 if k != LM_KERNEL[name]][0]
        if dev.type == "cuda":
            require(got[LM_KERNEL[name]] == want[LM_KERNEL[name]],
                    f"{name}: {LM_KERNEL[name]} launched "
                    f"{got[LM_KERNEL[name]]} times in {stats['prefills']} "
                    f"prefills, expected {want[LM_KERNEL[name]]}")
            require(got[other] == 0, f"{name}: {other} launched "
                    f"{got[other]} times")
        decoded = sum(len(v) - 1 for v in done.values())
        runs[name] = {
            "requests": n_requests,
            "prompt_lengths": [len(p) for _, p, _ in reqs],
            "tokens_generated": sum(len(v) for v in done.values()),
            "decode_steps": stats["decode_steps"],
            "prefills": stats["prefills"],
            "prefill_ms_per_request": 1e3 * stats["prefill_s"]
            / stats["prefills"],
            "decode_tokens_per_s": decoded / stats["decode_s"],
            "wall_s": stats["wall_s"], "launches": got, "grids": got_grids,
            "expected_launches": want,
            "params": count_params(eng.params),
            "kernel_vs_plain_prefill": _prefill_kernel_vs_plain(
                eng, reqs[0][1])}

    flash = gw_launches["flash_attention"] + sum(
        r["launches"]["flash_attention"] for r in runs.values())
    ssd = gw_launches["ssd_scan"] + sum(
        r["launches"]["ssd_scan"] for r in runs.values())
    path_grids = {k: gw_grids[k] + sum(r["grids"][k] for r in runs.values())
                  for k in gw_grids}
    return {"phase": "lm_plane", "make": make, "load": load,
            "gateway": {"slots": slot_rows, "wall_s": gw_wall,
                        "lm_requests": served, "images": images,
                        "launches": gw_launches,
                        "grids": gw_grids,
                        "expected_launches": expect(served)},
            "engine_runs": runs, "bucket_counts": {
                n: {str(b): bs.count(b) for b in sorted(set(bs))}
                for n, bs in buckets.items()},
            "flash_attention_launches": flash, "ssd_scan_launches": ssd,
            "grids": path_grids, "n_layers": n_layers}


# -- 9. fleet ------------------------------------------------------------------

FLEET_CELLS = 64
FLEET_SUMMARY = ("requests", "admitted", "dropped", "truncated", "drop_rate",
                 "slo_viol_rate", "deadline_miss_rate", "mean_latency_s",
                 "mean_wait_s", "p50_s", "p95_s", "p99_s", "end_backlog_s",
                 "mean_backlog_s", "peak_backlog_s", "peak_queue_depth")
# cell 0 of the fleet against a one-cell fleet: the same arrivals exactly;
# the latencies through the chain at R = 64 and R = 1, whose plans (rows
# per cluster) differ, so the actions agree to the chain's rounding only
FLEET_CELL0_LAT_TOL = 1e-3


def _sum_by_key(dicts) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _fleet_kernel_shapes(cfg: T2DRLCfg, C: int, slots: int) -> dict:
    """The fleet's ddpm_chain launches by timing case: one chain a slot at
    R = C for a diffusion allocator, none otherwise."""
    if cfg.allocator != "d3pg":
        return {}
    return {"control" if C == 1 else f"control_R{C}": slots}


def _fleet_run(dev, ts, cfg, fcfg, C: int, seed: int) -> tuple:
    """One horizon of C cells, as simulate_fleet runs it (fleet_run on the
    device, then summarize_fleet on the host) with the launches reset just
    before and read just after; the summary keys, the exact conservation
    checks and, on the card, one ddpm_chain launch a slot and no other
    kernel.  Returns the row and the per-cell counters and per-frame
    snapshots (numpy) for the cell-0 check."""
    from repro_torch.fleet import fleet_run, summarize_fleet
    from repro_torch.fleet.twin import _host
    ec = cfg.env
    slots = ec.T * ec.K
    pol = export_policy(ts, cfg)
    models = ModelParams(*(x.expand((C,) + tuple(x.shape))
                           for x in ts["models"]))
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        run = fleet_run(pol, models, cfg, fcfg, cell_generators(seed, C, dev))
    counts, hist, curves, snaps = (_host(x) for x in run)
    wall = time.perf_counter() - t0
    res = summarize_fleet(counts, hist, curves, cfg, fcfg, wall, snaps=snaps)
    launches = dict(ops.LAUNCHES)
    grids = dict(ops.GRIDS)
    require(res["requests"] == res["admitted"] + res["dropped"],
            f"fleet C={C}: {res['requests']} requests, {res['admitted']} "
            f"admitted + {res['dropped']} dropped")
    require(float(res["hist"].sum()) == res["admitted"] > 0,
            f"fleet C={C}: histogram {res['hist'].sum()} entries, "
            f"{res['admitted']} admitted")
    require(all(math.isfinite(res[k]) for k in FLEET_SUMMARY),
            f"fleet C={C}: {[(k, res[k]) for k in FLEET_SUMMARY]}")
    want = sum(_fleet_kernel_shapes(cfg, C, slots).values())
    if dev.type == "cuda":
        require(launches["ddpm_chain"] == want
                and sum(launches.values()) == want,
                f"fleet C={C}: launched {launches}, expected {want} "
                f"ddpm_chain (one a slot)")
    return {"cells": C, "wall_s_per_horizon": wall,
            "requests_per_wall_s": res["requests"] / wall,
            "simulated_s": res["sim_seconds"],
            "launches": launches, "grids": grids,
            "launches_by_shape": _fleet_kernel_shapes(cfg, C, slots),
            **{k: res[k] for k in FLEET_SUMMARY}}, (counts, snaps)


def _fleet_cell0(fleet, alone, C: int) -> dict:
    """Cell 0 of a C-cell fleet (``fleet``: its counters and snapshots)
    against a one-cell fleet from the same seed (``alone``): its arrivals
    and truncations, per frame, exactly the one-cell fleet's; its latency
    and wait sums within FLEET_CELL0_LAT_TOL."""
    (a, sa), (b, sb) = (({k: v[0].item() for k, v in counts.items()},
                         {k: v[0].tolist()
                          for k, v in snaps["counts"].items()})
                        for counts, snaps in (fleet, alone))
    for k in ("arrivals", "truncated"):
        require(sa[k] == sb[k], f"fleet cell 0 {k} per frame: {sa[k]} at "
                f"C={C}, {sb[k]} alone")
    rel = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
           for k in ("lat_sum", "wait_sum")}
    require(max(rel.values()) <= FLEET_CELL0_LAT_TOL,
            f"fleet cell 0 latency sums differ by {rel}")
    return {"arrivals": a["arrivals"], "arrivals_alone": b["arrivals"],
            "admitted": a["admitted"], "admitted_alone": b["admitted"],
            "lat_sum_rel_diff": rel["lat_sum"],
            "wait_sum_rel_diff": rel["wait_sum"]}


def phase_fleet(device, env_cfg: EnvCfg = EnvCfg(), fleet_cfg=None,
                cells: int = FLEET_CELLS, ckpt=None,
                warmup: int = OPS_WARMUP, seed: int = 0) -> dict:
    """The request-level fleet twin at ``env_cfg`` and ``FleetCfg()``'s
    defaults (one horizon: T*K slots of ticks_per_slot ticks) over
    ``cells`` cells: the 2-episode d3pg/ddqn state that phase ``ops``
    checkpointed (``ckpt``; trained here when None), restored through
    load_train_state, and an rcars/random state.  Per state: wall s a
    horizon, requests and requests per wall second, the summary keys,
    conservation exactly, one ddpm_chain launch a slot whatever the fleet
    size; the device kernels a slot (torch.profiler over one frame); and
    cell 0 of the fleet against a one-cell fleet from the same seed."""
    from repro_torch.fleet import FleetCfg, simulate_fleet
    dev = resolve_device(device)
    fcfg = FleetCfg() if fleet_cfg is None else fleet_cfg
    ec = env_cfg
    cfg = _ops_cfg("d3pg", "ddqn", ec, 2, warmup)
    if ckpt is None:
        ts, _ = train_t2drl(cfg, episodes=2, device=dev)
        source = "trained here, 2 episodes"
    else:
        ts, _ = load_train_state(ckpt, cfg, device=dev)
        source = "phase ops' checkpoint, load_train_state"
    cfg_r = T2DRLCfg(env=ec, allocator="rcars", cacher="random")
    ts_r = t2drl_init(make_generator(seed, dev), cfg_r)
    runs, raw = {}, {}
    for key, state, c, n in (("t2drl", ts, cfg, cells),
                             ("t2drl_C1", ts, cfg, 1),
                             ("rcars", ts_r, cfg_r, cells)):
        runs[key], raw[key] = _fleet_run(dev, state, c, fcfg, n, seed)
    frame = dataclasses.replace(cfg, env=dataclasses.replace(ec, T=1))
    kernels = None
    if dev.type == "cuda":
        _, kernels, _ = device_ms_per_call(lambda: simulate_fleet(
            ts, frame, fcfg, num_cells=cells, seed=seed, device=dev), 1)
        kernels /= ec.K
    return {"phase": "fleet", "env": {"U": ec.U, "M": ec.M, "T": ec.T,
                                      "K": ec.K},
            "fleet_cfg": dataclasses.asdict(fcfg), "state": source,
            "runs": runs, "device_kernels_per_slot": kernels,
            "cell0": _fleet_cell0(raw["t2drl"], raw["t2drl_C1"], cells),
            "launches_by_shape": {"ddpm_chain": _sum_by_key(
                [r["launches_by_shape"] for r in runs.values()])},
            "grids": {"ddpm_chain": sum(r["grids"]["ddpm_chain"]
                                        for r in runs.values())}}


# -- 10. every LM architecture ---------------------------------------------------

ARCH_ORDER = ("qwen2-0.5b", "mamba2-130m", "olmo-1b", "qwen3-4b",
              "codeqwen1.5-7b", "internvl2-2b", "zamba2-7b", "whisper-small",
              "deepseek-v2-236b", "deepseek-v3-671b")
DEEPSEEK_V2_LAYERS = 2      # one dense layer, then one MoE layer
VLM_TEXT = 64               # text tokens behind the 256 patch slots


def _arch_cfg(name: str, make: str):
    """The config an architecture runs at in phase lm_archs, and its cuts:
    full width and depth where one card holds the f32 weights;
    deepseek-v2-236b at full width with its depth cut to one dense and one
    MoE layer; deepseek-v3-671b at its smoke width (one full-width MoE
    layer is ~45 GB in f32, its MTP block another)."""
    arch = get_arch(name)
    if make == "make_smoke" or name == "deepseek-v3-671b":
        cut = [] if make == "make_smoke" else [
            "make_smoke width (one full-width MoE layer of 256 experts is "
            "~45 GB in f32, its MTP block another); its MLA and MoE code is "
            "deepseek-v2's"]
        return arch.make_smoke(), cut
    cfg = arch.make_full()
    if name == "deepseek-v2-236b":
        dense, moe_g = cfg.groups
        cfg = dataclasses.replace(cfg, groups=(
            dataclasses.replace(dense, repeats=1),
            dataclasses.replace(moe_g, repeats=DEEPSEEK_V2_LAYERS - 1)))
        return cfg, [f"depth 60 -> {DEEPSEEK_V2_LAYERS} layers (1 dense, "
                     "then 1 MoE layer of 160 experts): the f32 weights of "
                     "one card's 80 GB"]
    return cfg, []


def _mixer_blocks(cfg, mixer: str) -> list:
    """The block configs of every layer with ``mixer``, repeats counted."""
    if hasattr(cfg, "dec_group"):          # whisper: the decoder's
        cfg = SimpleNamespace(groups=(cfg.dec_group(),))
    return [b for g in cfg.groups for _ in range(g.repeats) for b in g.cycle
            if b.mixer == mixer]


def _plain_mla_layers(cfg) -> int:
    """MLA layers whose head pair the kernel is not built for: each runs
    the plain products in a prefill, counted in ``ops.PLAIN_PREFILLS``."""
    return sum((b.mla.qk_nope_dim + b.mla.qk_rope_dim, b.mla.v_head_dim)
               not in ops.FLASH_HEAD_PAIRS for b in _mixer_blocks(cfg, "mla"))


def _prefill_shapes(cfg, L: int) -> dict:
    """The kernel launches one prefill of L positions makes, by kernel and
    shape: flash_attention (1, L, H, Hkv, D) per attention layer,
    flash_mla (1, L, H, H, (D, DV)) per MLA layer whose head pair the
    kernel is built for (``_plain_mla_layers`` counts the others),
    ssd_scan (1, L, H, P, G, N, chunk) per Mamba2 layer."""
    out = {"flash_attention": {}, "flash_mla": {}, "ssd_scan": {}}
    for b in _mixer_blocks(cfg, "attn"):
        a = b.attn
        key = _shape_key((1, L, a.n_heads, a.n_kv_heads, a.d_head))
        out["flash_attention"][key] = out["flash_attention"].get(key, 0) + 1
    for b in _mixer_blocks(cfg, "mla"):
        m = b.mla
        pair = (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim)
        if pair in ops.FLASH_HEAD_PAIRS:
            key = _shape_key((1, L, m.n_heads, m.n_heads) + pair)
            out["flash_mla"][key] = out["flash_mla"].get(key, 0) + 1
    for b in _mixer_blocks(cfg, "ssm"):
        c = b.ssm
        key = _shape_key((1, L, c.n_heads, c.head_dim, c.n_groups,
                          c.d_state, c.chunk))
        out["ssd_scan"][key] = out["ssd_scan"].get(key, 0) + 1
    return out


def _add_prefill(total: dict, cfg, L: int, n: int = 1) -> None:
    for kern, by in _prefill_shapes(cfg, L).items():
        for key, c in by.items():
            by_key = total.setdefault(kern, {})
            by_key[key] = by_key.get(key, 0) + n * c


def _logits_vs_plain(fn, what: str) -> dict:
    """Last-token logits of ``fn(impl)`` through the kernels and through
    the plain versions (LM_PREFILL_TOL of their largest magnitude)."""
    with torch.no_grad():
        out = {impl: fn(impl).float() for impl in ("kernel", "plain")}
    scale = out["plain"].abs().max().item()
    err = (out["kernel"] - out["plain"]).abs().max().item()
    require(bool(torch.isfinite(out["kernel"]).all())
            and bool(torch.isfinite(out["plain"]).all()),
            f"{what}: non-finite prefill logits")
    require(err <= LM_PREFILL_TOL * scale, f"{what}: prefill logits kernel "
            f"vs plain differ by {err} > {LM_PREFILL_TOL} x {scale}")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "tolerance_rel": LM_PREFILL_TOL,
            "same_argmax": bool(out["kernel"].argmax()
                                == out["plain"].argmax())}


def _weights_bytes(tree) -> int:
    leaves = []
    lm_mod.tree_map(lambda t: leaves.append(t.numel() * t.element_size()),
                    tree)
    return sum(leaves)


def _check_launches(dev, got: dict, want: dict, totals: dict,
                    what: str) -> None:
    """On the card: each LM kernel launched exactly ``want`` times (per
    kernel, summed over shapes) and no other kernel.  Adds ``want`` to the
    phase's launches by shape and the grids the run started to its
    grids."""
    n = {k: sum(want.get(k, {}).values()) for k in ops.LAUNCHES}
    if dev.type == "cuda":
        require(got == n, f"{what}: launched {got}, expected {n}")
    for kern, by in want.items():
        _add_shapes(totals["by_shape"], {kern: by})
        totals["grids"][kern] = totals["grids"].get(kern, 0) \
            + ops.GRIDS[kern]


def _serve_arch(dev, name, cfg, params, rng, n_requests, max_prompt,
                max_seq, max_new, totals) -> dict:
    """One Engine.run of ``n_requests`` prompts of 8..max_prompt tokens,
    ``max_new`` new tokens each; launches exact; one prefill through the
    kernels against the plain versions."""
    eng = Engine(cfg, params, ServeCfg(max_batch=4, max_seq=max_seq),
                 device=dev)
    reqs = [(i, rng.integers(0, cfg.vocab, size=int(rng.integers(
        8, max_prompt + 1))), max_new) for i in range(n_requests)]
    with _FiniteLogits() as fin:
        ops.reset_launches()
        sync(dev)
        done, stats = eng.run(reqs)
        sync(dev)
        got = dict(ops.LAUNCHES)
        plain = ops.PLAIN_PREFILLS["mla"]
        finite = fin.all_finite()
    require(finite, f"{name}: non-finite logits in Engine.run")
    require(sorted(done) == list(range(n_requests)) and all(
        len(done[i]) == _generated(len(p), mnt, max_seq)
        for i, p, mnt in reqs),
        f"{name}: generated lengths {[len(v) for v in done.values()]}")
    want = {"flash_attention": {}, "flash_mla": {}, "ssd_scan": {}}
    buckets = [min(_bucket(len(p)), max_seq) for _, p, _ in reqs]
    for Lb in buckets:
        _add_prefill(want, cfg, Lb)
    _check_launches(dev, got, want, totals, f"{name} Engine.run")
    want_plain = _plain_mla_layers(cfg) * n_requests
    require(plain == want_plain, f"{name}: {plain} MLA prefills ran the "
            f"plain products, expected {want_plain}")
    totals["plain_mla_prefills"] = totals.get("plain_mla_prefills", 0) \
        + plain
    decoded = sum(len(v) - 1 for v in done.values())
    out = {"requests": n_requests, "buckets": buckets,
           "prompt_lengths": [len(p) for _, p, _ in reqs],
           "tokens_generated": sum(len(v) for v in done.values()),
           "decode_steps": stats["decode_steps"],
           "prefill_ms_per_request": 1e3 * stats["prefill_s"]
           / stats["prefills"],
           "decode_tokens_per_s": decoded / stats["decode_s"],
           "wall_s": stats["wall_s"], "launches": got,
           "plain_mla_prefills": plain,
           "kernel_vs_plain_prefill": _prefill_kernel_vs_plain(
               eng, reqs[0][1])}
    del eng
    return out


def _serve_whisper(dev, cfg, params, seed, max_seq, max_new,
                   totals) -> dict:
    """whisper_prefill of a 16-token prompt behind (1, n_frames, d_model)
    frame embeddings, then ``max_new`` greedy whisper_decode steps; the
    decoder's self-attention through flash_attention, one launch a layer;
    the prefill against the plain versions."""
    from repro_torch.models.whisper import (whisper_decode,
                                            whisper_init_cache,
                                            whisper_prefill)
    g = torch.Generator().manual_seed(seed)
    fe = torch.randn((1, cfg.n_frames, cfg.d_model), generator=g).to(dev)
    L = 16
    toks = torch.randint(0, cfg.vocab, (1, L), generator=g).to(dev)
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = whisper_prefill(params, cfg, fe, toks,
                                        whisper_init_cache(cfg, 1, max_seq,
                                                           device=dev))
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        finite = [torch.isfinite(logits).all()]
        t0 = time.perf_counter()
        for i in range(max_new):
            logits, cache = whisper_decode(params, cfg, tok, cache, L + i)
            finite.append(torch.isfinite(logits).all())
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        sync(dev)
        decode_s = time.perf_counter() - t0
    require(bool(torch.stack(finite).all()), "whisper: non-finite logits")
    want = {"flash_attention": {}, "ssd_scan": {}}
    _add_prefill(want, cfg, L)
    _check_launches(dev, got, want, totals, "whisper prefill")
    return {"frame_embeds": [1, cfg.n_frames, cfg.d_model],
            "prompt": L, "new_tokens": max_new,
            "prefill_ms": 1e3 * prefill_s,
            "decode_tokens_per_s": max_new / decode_s, "launches": got,
            "kernel_vs_plain_prefill": _logits_vs_plain(
                lambda impl: whisper_prefill(
                    params, cfg, fe, toks, whisper_init_cache(
                        cfg, 1, max_seq, device=dev), impl=impl)[0],
                "whisper")}


def _vlm_prefix(dev, cfg, params, seed, max_seq, totals) -> dict:
    """One direct lm_prefill with random prefix_embeds (1, n_prefix,
    prefix_embed_dim) before VLM_TEXT text tokens (fewer if max_seq
    holds fewer): one flash_attention launch a layer at L = n_prefix +
    the text, against the plain versions."""
    g = torch.Generator().manual_seed(seed)
    pre = torch.randn((1, cfg.n_prefix, cfg.prefix_embed_dim),
                      generator=g).to(dev)
    n_text = min(VLM_TEXT, max_seq - cfg.n_prefix)
    toks = torch.randint(0, cfg.vocab, (1, n_text), generator=g).to(dev)

    def prefill(impl):
        return lm_mod.lm_prefill(
            params, cfg, toks, lm_mod.lm_init_cache(cfg, 1, max_seq,
                                                    device=dev),
            prefix_embeds=pre, impl=impl)[0]
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = prefill("kernel")
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    got = dict(ops.LAUNCHES)
    require(bool(torch.isfinite(logits).all()), "VLM prefix: non-finite")
    want = {"flash_attention": {}, "ssd_scan": {}}
    _add_prefill(want, cfg, cfg.n_prefix + n_text)
    _check_launches(dev, got, want, totals, "VLM prefix prefill")
    return {"prefix_embeds": list(pre.shape), "text_tokens": n_text,
            "prefill_ms": ms, "launches": got,
            "kernel_vs_plain_prefill": _logits_vs_plain(prefill,
                                                        "VLM prefix")}


def phase_lm_archs(device, make: str = "make_full", n_requests: int = 4,
                   max_prompt: int = 300, max_seq: int = 512,
                   max_new: int = 16, archs=ARCH_ORDER,
                   seed: int = 0) -> dict:
    """Every architecture of the registry, one at a time (freed before the
    next), with random f32 weights from ``seed``: each decoder-only LM
    behind Engine(max_batch=4, max_seq) serving ``n_requests`` prompts of
    8..max_prompt tokens, ``max_new`` new tokens each (internvl2-2b also
    one direct prefill with its 256 patch slots), whisper-small through
    whisper_prefill and whisper_decode.  Launches exact (one
    flash_attention per attention layer and one ssd_scan per Mamba2 layer
    a prefill); one prefill against the plain versions; prefill ms,
    decode tokens/s, weight bytes, and the cuts (``reduced``).  MLA layers
    launch ``flash_mla`` at the head pair the kernel is built for
    (deepseek-v2's at full width); at other widths (the smoke configs,
    deepseek-v3's here) their prefills run the plain products, each
    counted in ``plain_mla_prefills``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    totals = {"by_shape": {"flash_attention": {}, "flash_mla": {},
                           "ssd_scan": {}},
              "grids": {"flash_attention": 0, "flash_mla": 0, "ssd_scan": 0},
              "plain_mla_prefills": 0}
    out = {}
    for i, name in enumerate(archs):
        arch = get_arch(name)
        cfg, reduced = _arch_cfg(name, make)
        t0 = time.perf_counter()
        if arch.kind == "whisper":
            from repro_torch.models.whisper import whisper_init
            params = whisper_init(make_generator(100 + i, dev), cfg)
        else:
            params = lm_mod.lm_init(make_generator(100 + i, dev), cfg)
        sync(dev)
        row = {"width": make if not reduced or "depth" in reduced[0]
               else "make_smoke", "reduced": reduced,
               "init_s": time.perf_counter() - t0,
               "weights_bytes": _weights_bytes(params),
               "params": count_params(params),
               "attention_layers": len(_mixer_blocks(cfg, "attn")),
               "mla_layers": len(_mixer_blocks(cfg, "mla")),
               "ssm_layers": len(_mixer_blocks(cfg, "ssm"))}
        if arch.kind == "whisper":
            row.update(_serve_whisper(dev, cfg, params, seed + i, max_seq,
                                      max_new, totals))
        else:
            row.update(_serve_arch(dev, name, cfg, params, rng, n_requests,
                                   max_prompt, max_seq, max_new, totals))
            if cfg.prefix_embed_dim:
                row["prefix_prefill"] = _vlm_prefix(dev, cfg, params,
                                                    seed + i, max_seq,
                                                    totals)
        out[name] = row
        del params
        gc.collect()
        if dev.type == "cuda":
            row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return {"phase": "lm_archs", "make": make, "dtype": "float32 weights, "
            "bfloat16 compute", "archs": out,
            "launches_by_shape": totals["by_shape"],
            "grids": totals["grids"],
            "flash_attention_launches": sum(
                totals["by_shape"]["flash_attention"].values()),
            "flash_mla_launches": sum(
                totals["by_shape"]["flash_mla"].values()),
            "plain_mla_prefills": totals["plain_mla_prefills"],
            "ssd_scan_launches": sum(totals["by_shape"]["ssd_scan"]
                                     .values())}


def _flash_row(device, B, L, H, Hkv, D, DV=None) -> dict:
    """Timing row of flash_attention at one bf16 causal shape, with SDPA's
    time at the same shape beside it; the kernel's output is held against
    the plain version's on the same inputs first, as in the kernel check.
    With ``DV`` (v's head size) the shape is a pair of
    ``ops.FLASH_HEAD_PAIRS``, run with MLA's scale (``MLA_SCALE``) and
    counted under the pair's key."""
    shape = [B, L, H, Hkv, D] + ([DV] if DV else [])
    key = ops.FLASH_HEAD_PAIRS[(D, DV)] if DV else "flash_attention"
    scale = MLA_SCALE if DV else None
    q, k, v = _flash_inputs(B, H, Hkv, L, L, D, torch.bfloat16, device,
                            seed=L + D, DV=DV)
    held = _hold_flash(
        ops.flash_attention(q, k, v, causal=True, scale=scale),
        ref.flash_attention_ref(q, k, v, causal=True, scale=scale),
        f"flash_attention {shape} bfloat16")
    library, call = _sdpa_call(q, k, v, scale)

    def kernel():
        ops.flash_attention(q, k, v, causal=True, scale=scale)

    t = _timed_turns(kernel, lambda: ref.flash_attention_ref(
        q, k, v, causal=True, scale=scale), library)
    bound, by, peak = flash_bound_ms(B, L, L, H, Hkv, D, 2, DV=DV)
    return {"shape": shape, "dtype": "bfloat16", **held, **t,
            "bound_ms": bound, "bound_by": by, "peak": peak,
            "library_call": call,
            "grids_per_call": _grids_per_call(kernel, key)}


def _ssd_row(device, B, L, H, P, G, N, chunk) -> dict:
    """Timing row of ssd_scan at one shape, its output held against the
    plain version's on the same inputs first, as in the kernel check."""
    args = _ssd_inputs(B, L, H, P, G, N, device, seed=L + H)
    err = _hold_ssd(ops.ssd_scan(*args, chunk=chunk),
                    ref.ssd_scan_ref(*args, chunk=chunk),
                    f"ssd_scan {[B, L, H, P, G, N, chunk]}")

    def kernel():
        ops.ssd_scan(*args, chunk=chunk)

    t = _timed_turns(kernel, lambda: ref.ssd_scan_ref(*args, chunk=chunk))
    bound, by, peak = ssd_bound_ms(B, L, H, P, G, N, chunk)
    return {"shape": [B, L, H, P, G, N, chunk], "dtype": "float32",
            "max_abs_err": err, **t,
            "bound_ms": bound, "bound_by": by, "peak": peak,
            "grids_per_call": _grids_per_call(kernel, "ssd_scan")}


def phase_arch_timing(device, timing: dict, archs: dict,
                      mla_lengths=()) -> dict:
    """Timing rows of flash_attention, flash_mla and ssd_scan at every
    shape that phase lm_archs launched and phase kernel_timing did not
    time (the other architectures' heads: d_head 112, 128 with 8 kv heads,
    ...; deepseek-v2's MLA pair; zamba2-7b's Mamba2 layers), and of
    flash_mla at DeepSeek's heads at each of ``mla_lengths``, each held
    against its plain version on the same inputs; the shapes phase
    kernel_timing timed are the kernel check's cases.  So every shape
    either LM phase launched is held."""
    rows = {}
    for kern, make in (("flash_attention", _flash_row),
                       ("flash_mla", _flash_row), ("ssd_scan", _ssd_row)):
        have = {_shape_key(r["shape"]) for r in timing.get(kern, [])}
        keys = set(archs["launches_by_shape"].get(kern, {}))
        if kern == "flash_mla":
            keys |= {_shape_key((1, L) + MLA_HEADS) for L in mla_lengths}
        rows[kern] = [make(device, *map(int, key.split("x")))
                      for key in sorted(keys) if key not in have]
    return {"phase": "arch_timing", **rows}


# -- 12. LM training -------------------------------------------------------------

LM_TRAIN_FULL = ("qwen2-0.5b", "mamba2-130m")
# the training CLI's defaults (repro_torch/launch/train.py): batch 8, seq
# 128, lr 3e-4; 20 steps
LM_TRAIN = dict(steps=20, batch=8, seq_len=128, lr=3e-4)
LM_TRAIN_WIDE = ("whisper-small", "deepseek-v3-671b")   # 5 steps each
LM_TRAIN_WIDE_STEPS = 5
LONG_TRAIN_L = 2048          # qwen2-0.5b, batch 1: plain vs chunked
# plain against chunked attention at LONG_TRAIN_L (two 1024-key blocks).
# The bf16 train step's loss: both round the same bf16 q, k, v; the chunked
# path sums the softmax in blocks and rounds its output once.  In f32
# compute: the loss, and the q/k/v weights' gradients of every layer by
# relative L2 (the chunked backward against autograd of the plain path).
# Each limit is ten times the reading on the H100 (PERF.md §5).
LONG_LOSS_TOL = 2e-4           # relative; read 1.76e-5
LONG_F32_LOSS_TOL = 1e-6       # relative; read 0.0 (ten f32 ulps at 12.5)
LONG_F32_GRAD_TOL = 5e-5       # relative L2; read 4.55e-6
# tests/test_system.py:21's requirement of the JAX package: qwen2-0.5b at
# its smoke width, 60 steps at lr 3e-3, batch 8, seq 64, loss down > 0.5
LM_CONVERGE = dict(steps=60, batch=8, seq_len=64, lr=3e-3)
LM_CONVERGE_DROP = 0.5


def _no_lm_kernels(what: str) -> dict:
    """The launches since the last reset; none may be an LM kernel (the
    kernels have no backward: training runs the plain and chunked
    paths)."""
    got = dict(ops.LAUNCHES)
    require(got["flash_attention"] == 0 and got["ssd_scan"] == 0,
            f"{what}: LM kernels launched while training: {got}")
    return got


def _check_history(hist, sched, what: str) -> None:
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"])
                for h in hist), f"{what}: non-finite loss or gnorm")
    lrs = [float(sched(i)) for i in range(len(hist))]
    require([h["lr"] for h in hist] == lrs,
            f"{what}: lrs {[h['lr'] for h in hist]}, schedule {lrs}")


def _unchanged_leaves(init, params) -> list:
    """Indices (``tree_leaves`` order) of the leaves training left equal
    to their initial values."""
    return [i for i, (a, b) in enumerate(zip(lm_mod.tree_leaves(init),
                                             lm_mod.tree_leaves(params)))
            if torch.equal(a, b.detach())]


def _peak_reset(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _train_run(dev, name: str, *, smoke: bool, steps: int, batch: int,
               seq_len: int, lr: float, seed: int, ckpt: str = "") -> tuple:
    """``train_loop`` from random f32 weights (``seed``): finite losses
    and gnorms, the schedule's lr at every step, no LM kernel launched;
    with ``changed``, every parameter leaf moved.  Returns (row, params,
    opt, the setup)."""
    setup = train_setup(name, smoke=smoke, steps=steps, batch=batch,
                        seq_len=seq_len, lr=lr, device=dev)
    _peak_reset(dev)
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    params, opt, hist = train_loop(name, smoke=smoke, steps=steps,
                                   batch=batch, seq_len=seq_len, lr=lr,
                                   log_every=0, seed=seed, ckpt=ckpt,
                                   device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = _no_lm_kernels(f"{name} train_loop")
    _check_history(hist, setup[2], name)
    later = [h["s"] for h in hist[1:]] or [hist[0]["s"]]
    s_step = float(np.median(later))
    row = {"width": "make_smoke" if smoke else "make_full", "steps": steps,
           "batch": batch, "seq_len": seq_len, "lr": lr, "wall_s": wall,
           "s_per_step": s_step, "first_step_s": hist[0]["s"],
           "tokens_per_s": batch * seq_len / s_step,
           "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
           "gnorm_last": hist[-1]["gnorm"], "lrs": [h["lr"] for h in hist],
           "params": count_params(params), "peak_memory_bytes": _peak(dev),
           "launches": {k: v for k, v in launches.items() if v}}
    return row, params, opt, setup


def _step_profile(dev, params, opt, setup, seed: int) -> dict:
    """One more step of a trained state, measured three ways on a fixed
    batch: host ms (3 steps, each ending in a synchronise); on the card,
    device ms and kernels a step from torch.profiler and the idle share
    of the host time; FLOPs and bytes of one step (``roofline.step_cost``,
    whose count of a step with no mesh is FlopCounterMode's), their
    roofline terms against the H100's peaks, ``mfu`` (6·N·tokens over the step's host time, against 989
    TFLOP/s) and ``useful_ratio`` (6·N·tokens over the counted FLOPs)."""
    arch, cfg, _, _, train_step, batch_fn = setup
    b = batch_fn(torch.Generator().manual_seed(seed + 1))
    state = {"params": params, "opt": opt}

    def one():
        state["params"], state["opt"], m = train_step(
            state["params"], state["opt"], b)
        return m

    one()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    sync(dev)
    host_ms = 1e3 * (time.perf_counter() - t0) / 3
    tokens = b["labels"].numel()
    n_active = count_params(params) * active_fraction(cfg)
    mf = model_flops(n_active, tokens)
    _, cost = step_cost(one)
    rf = roofline(cost, {}, chips=1, model_flops_total=mf)
    out = {"host_ms_per_step": host_ms, "tokens": tokens,
           "active_params": n_active, "model_flops": mf,
           "counted_flops": cost["flops"], "counted_bytes":
           cost["bytes accessed"], "useful_ratio": rf.useful_ratio,
           "roofline": {k: getattr(rf, k) for k in (
               "compute_s", "memory_s", "bottleneck")},
           "mfu": None}
    if dev.type == "cuda":
        out["mfu"] = mf / (host_ms / 1e3) / PEAK_FLOPS
        events, kernels, _ = device_ms_per_call(one, 3)
        busy = sum(events.values())
        out.update(device_ms_per_step=busy,
                   device_idle_share=1.0 - busy / host_ms,
                   device_kernels_per_step=kernels,
                   device_ms_top=dict(sorted(events.items(),
                                             key=lambda kv: -kv[1])[:6]))
    return out


def _qkv_grads(params, cfg, batch, impl: str) -> tuple:
    """The f32-compute loss through ``impl`` and the gradients of the q,
    k and v projection weights (each stacked over the layers), on the
    host."""
    mixer = params["groups"][0]["stacked"]["0"]["mixer"]
    leaves = [mixer[k]["w"] for k in ("q", "k", "v")]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm_mod.lm_loss(params, cfg, batch, impl=impl,
                             compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu() for g in grads]


def _max_layer_rel_l2(want: list, got: list) -> float:
    """max over the leaves and their layers (axis 0) of ||got - want|| /
    ||want||."""
    return max(float(((g - w).flatten(1).norm(dim=1)
                      / w.flatten(1).norm(dim=1)).max())
               for w, g in zip(want, got))


def _plain_vs_chunked(dev, name: str, smoke: bool, L: int,
                      seed: int) -> dict:
    """``name`` at batch 1 and length L through each attention impl from
    the same weights and batch.  In f32 compute: the loss and the q, k, v
    weights' gradients of every layer (so the chunked backward), held to
    LONG_F32_LOSS_TOL and LONG_F32_GRAD_TOL.  Then one bf16 train step
    (after a warm-up step): s/step, peak memory, and its loss, held to
    LONG_LOSS_TOL."""
    out, f32 = {}, {}
    for impl in ("plain", "chunked"):
        _, cfg, _, init_fn, train_step, batch_fn = train_setup(
            name, smoke=smoke, steps=2, batch=1, seq_len=L,
            opts=PerfOpts(impl=impl), device=dev)
        params, opt = init_fn(make_generator(seed, dev))
        b = batch_fn(torch.Generator().manual_seed(seed))
        ops.reset_launches()
        f32[impl] = _qkv_grads(params, cfg, b, impl)
        _peak_reset(dev)
        params, opt, m = train_step(params, opt, b)       # lr 0: no move
        loss = float(m["loss"])
        sync(dev)
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, b)
        float(m["loss"])
        sync(dev)
        _no_lm_kernels(f"{name} L={L} {impl}")
        out[impl] = {"s_per_step": time.perf_counter() - t0, "loss": loss,
                     "peak_memory_bytes": _peak(dev)}
        del params, opt, m
    rel = {"loss_rel_diff": abs(out["plain"]["loss"] - out["chunked"]["loss"])
           / abs(out["plain"]["loss"]),
           "f32_loss_rel_diff": abs(f32["plain"][0] - f32["chunked"][0])
           / abs(f32["plain"][0]),
           "f32_qkv_grad_rel_l2": _max_layer_rel_l2(f32["plain"][1],
                                                     f32["chunked"][1])}
    tol = {"loss_rel_diff": LONG_LOSS_TOL,
           "f32_loss_rel_diff": LONG_F32_LOSS_TOL,
           "f32_qkv_grad_rel_l2": LONG_F32_GRAD_TOL}
    for k, v in rel.items():
        require(v <= tol[k], f"{name} L={L}: plain vs chunked {k} {v} > "
                f"{tol[k]}")
    return {"arch": name, "batch": 1, "seq_len": L, **out, **rel,
            "tolerance": tol}


def _serve_trained(dev, name: str, cfg, ckpt: str, params, rng,
                   n_requests, max_prompt, max_seq, max_new,
                   totals) -> dict:
    """The checkpoint of a trained state, read back onto the device
    (every parameter bit for bit the trained one), served behind
    Engine(max_batch=4, max_seq) with exact kernel launches and one
    prefill against the plain versions."""
    state = lm_train_state_from_numpy(load_pytree(ckpt), cfg, device=dev)
    same = all(torch.equal(a, b.detach()) for a, b in zip(
        lm_mod.tree_leaves(state["params"]), lm_mod.tree_leaves(params)))
    require(same, f"{name}: the checkpoint read back differs from the "
            "trained weights")
    row = _serve_arch(dev, name, cfg, state["params"], rng, n_requests,
                      max_prompt, max_seq, max_new, totals)
    row["checkpoint_bytes"] = Path(ckpt).stat().st_size
    row["opt_step"] = state["opt"]["step"]
    return row


def phase_lm_train(device, make: str = "make_full", train=LM_TRAIN,
                   wide_steps: int = LM_TRAIN_WIDE_STEPS,
                   long_L: int = LONG_TRAIN_L, converge=LM_CONVERGE,
                   n_requests: int = 4, max_prompt: int = 300,
                   max_seq: int = 512, max_new: int = 16, seed: int = 0,
                   ckpt_dir: str = "", card: str = "") -> dict:
    """LM training on the device (``card``: nvidia-smi's name and power
    limit, reported beside the numbers): qwen2-0.5b and mamba2-130m (``make``
    width, f32 weights from seeds, bf16 compute) for ``train`` steps
    through ``train_loop`` with ``--ckpt``, each profiled one step more;
    qwen2-0.5b at batch 1 and ``long_L`` through the plain and the
    chunked attention; whisper-small (``make`` width) and deepseek-v3-671b
    (its smoke width) for ``wide_steps`` steps; every other architecture
    one step at its smoke config; qwen2-0.5b's smoke config for
    ``converge``'s steps, its loss down by more than 0.5.  No LM kernel
    launches while training.  Then both trained checkpoints, read back
    onto the device, are served behind Engine(max_batch=4, max_seq) with
    exact flash_attention/ssd_scan launches (their counts by shape and
    grids are the phase's ``launches_by_shape`` and ``grids``)."""
    dev = resolve_device(device)
    smoke = make == "make_smoke"
    rng = np.random.default_rng(seed)
    totals = {"by_shape": {"flash_attention": {}, "ssd_scan": {}},
              "grids": {"flash_attention": 0, "ssd_scan": 0}}
    tmp = tempfile.TemporaryDirectory() if not ckpt_dir else None
    root = Path(ckpt_dir or tmp.name)
    full, serve, reduced = {}, {}, []
    try:
        for i, name in enumerate(LM_TRAIN_FULL):
            ckpt = str(root / f"{name}.ckpt")
            row, params, opt, setup = _train_run(
                dev, name, smoke=smoke, seed=seed + i, ckpt=ckpt, **train)
            init = setup[3](make_generator(seed + i, dev))[0]
            unchanged = _unchanged_leaves(init, params)
            require(not unchanged, f"{name}: leaves {unchanged} never "
                    "changed")
            del init
            row["leaves_changed"] = len(lm_mod.tree_leaves(params))
            serve[name] = _serve_trained(dev, name, setup[1], ckpt, params,
                                         rng, n_requests, max_prompt,
                                         max_seq, max_new, totals)
            row["step"] = _step_profile(dev, params, opt, setup, seed + i)
            full[name] = row
            del params, opt, setup
            _peak_reset(dev)
        long = _plain_vs_chunked(dev, "qwen2-0.5b", smoke, long_L, seed)
        _peak_reset(dev)
        wide = {}
        for i, name in enumerate(LM_TRAIN_WIDE):
            cut_smoke = smoke or name == "deepseek-v3-671b"
            if not smoke and cut_smoke:
                arch = get_arch(name)
                n = count_params(param_shapes(arch, arch.make_full()))
                reduced.append(f"{name}: make_smoke width (make_full has "
                               f"{n} parameters, {4 * n / 1e9:.0f} GB in "
                               "f32, Adam's moments twice that)")
            row, params, opt, _ = _train_run(
                dev, name, smoke=cut_smoke, steps=wide_steps,
                batch=train["batch"], seq_len=train["seq_len"],
                lr=train["lr"], seed=seed + 10 + i)
            wide[name] = row
            del params, opt
            _peak_reset(dev)
        others = {}
        rest = [a for a in ARCH_ORDER if a not in LM_TRAIN_FULL
                + LM_TRAIN_WIDE]
        if not smoke:
            reduced.append(f"{', '.join(rest)}: make_smoke width, one step")
        for i, name in enumerate(rest):
            row, params, opt, _ = _train_run(
                dev, name, smoke=True, steps=1, batch=train["batch"],
                seq_len=train["seq_len"], lr=train["lr"], seed=seed + 20 + i)
            others[name] = {k: row[k] for k in ("loss_first", "gnorm_last",
                                                "s_per_step")}
            del params, opt
        conv, params, opt, _ = _train_run(dev, "qwen2-0.5b", smoke=True,
                                          seed=seed, **converge)
        del params, opt
        drop = conv["loss_first"] - conv["loss_last"]
        require(drop > LM_CONVERGE_DROP, f"qwen2-0.5b smoke: loss "
                f"{conv['loss_first']} -> {conv['loss_last']}")
        conv["loss_drop"] = drop
    finally:
        if tmp is not None:
            tmp.cleanup()
    _peak_reset(dev)
    return {"phase": "lm_train", "make": make, "card": card,
            "dtype": "float32 weights, bfloat16 compute",
            "impl": "plain (chunked where named)", "reduced": reduced,
            "full": full, "long_context": long, "wide": wide,
            "others_smoke": others, "converge": conv, "serve": serve,
            "launches_by_shape": totals["by_shape"],
            "grids": totals["grids"],
            "flash_attention_launches": sum(
                totals["by_shape"]["flash_attention"].values()),
            "ssd_scan_launches": sum(totals["by_shape"]["ssd_scan"]
                                     .values())}


# -- 13. dist: cells sharded over ranks, expert parallelism, the examples -----

DIST_B = 8                   # the fused cells of phase vector, split 4/4
DIST_EPISODES = 2
DIST_MOE = ("deepseek-v2-236b", "make_full")    # one MoE layer, full width
DIST_MOE_TOKENS = (4, 128)   # rows x length, the same on both "model" ranks
DIST_LM = ("deepseek-v3-671b", "make_smoke")
DIST_LM_TOKENS = (2, 64)
DIST_TIMEOUT_S = 420
# the LM's mesh half: tensor-parallel serving on ("data", "model") =
# (1, 2), FSDP training on (2, 1), the serving steps on (1, 1) in the
# world of one
DIST_SERVE = (("qwen2-0.5b", "flash_attention"), ("mamba2-130m", "ssd_scan"))
DIST_PROMPTS = (4, 128)       # prompts x length
DIST_DECODE = 16
DIST_FSDP = dict(arch="qwen2-0.5b", steps=2, batch=8, seq_len=128, lr=3e-4)
DIST_FSDP_TOL = 4e-2          # relative L2 of a leaf's update in bf16
BF16_LOSS_TOL = 2e-2          # relative, the loss in bf16
# the example twins, with their reduced arguments (``reduced``)
DIST_EXAMPLES = {
    "quickstart_torch": ["--episodes", "2"],
    "serve_edge_torch": ["--train-episodes", "2", "--frames", "2",
                         "--slots", "2"],
    "train_lm_torch": ["--steps", "25"]}
DIST_TRAIN_KERNELS = ("ddpm_chain", "ddpm_chain_bwd")


def _state_digest(ts) -> dict:
    """sha256 of every leaf of a port train state (tensors by dtype, shape
    and bytes; host values by repr), by path."""
    out = {}
    for path, v in _port_leaves(ts):
        if torch.is_tensor(v):
            t = v.detach().cpu().contiguous()
            v = f"{t.dtype}{tuple(t.shape)}".encode() + t.reshape(
                -1).view(torch.uint8).numpy().tobytes()
        else:
            v = repr(v).encode()
        out[path] = hashlib.sha256(v).hexdigest()
    return out


def _dist_train(dev, rank: int, n: int, env_cfg: EnvCfg, B: int,
                episodes: int) -> dict:
    """``run_training_sharded`` of B fused cells over a ``("cells",)``
    mesh of the world: this rank's launches (reset just before, read just
    after), wall s, the state's digest and the history; then the gather
    alone, timed (this rank's slice written back: the same values)."""
    cfg = method_cfg("d3pg", "ddqn", env_cfg, episodes)
    mesh = make_cells_mesh()
    # a warm-up run from other seeds: the group's communicator, cuBLAS
    # and the kernels' modules come up before the timed run
    warm = cell_generators(cfg.seed + 1, B, dev)
    run_training_sharded(t2drl_init_batch(warm, cfg), cfg, warm, episodes,
                         mesh=mesh)
    gens = cell_generators(cfg.seed, B, dev)
    ts = t2drl_init_batch(gens, cfg)
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    ts, hist = run_training_sharded(ts, cfg, gens, episodes, mesh=mesh)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in DIST_TRAIN_KERNELS}
    grids = {k: ops.GRIDS[k] for k in DIST_TRAIN_KERNELS}
    lo = rank * B // n
    local = t2drl_mod._stack_states([cell_state(ts, cfg, b)
                                     for b in range(lo, lo + B // n)])
    group = mesh.get_group("cells")
    sync(dev)
    t1 = time.perf_counter()
    _, nbytes = t2drl_mod._gather_cells(ts, local, group)
    sync(dev)
    gather_ms = 1e3 * (time.perf_counter() - t1)
    # the collective alone on as many bytes, as the gather issues it (the
    # second of two calls: the first sets up buffers of this size)
    part = torch.zeros(nbytes // n, dtype=torch.uint8, device=dev)

    def collective():
        if torch.distributed.get_backend(group) == "nccl":
            torch.distributed.all_gather_into_tensor(
                torch.empty(nbytes, dtype=torch.uint8, device=dev), part,
                group=group)
        else:
            host = part.cpu()
            torch.distributed.all_gather(
                [torch.empty_like(host) for _ in range(n)], host,
                group=group)
        sync(dev)

    collective()
    t1 = time.perf_counter()
    collective()
    collective_ms = 1e3 * (time.perf_counter() - t1)
    return {"rank": rank, "cells": [lo, lo + B // n], "wall_s": wall,
            "wall_s_per_episode": wall / episodes, "launches": launches,
            "grids": grids, "updates": ts["d3pg"]["opt_a"]["step"],
            "digest": _state_digest(ts), "history": hist,
            "gather_bytes": nbytes, "gather_ms": gather_ms,
            "collective_ms": collective_ms}


def _event_ms(dev, fn, reps: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the DTensors (the plain tensors
    whole) in ``tree``."""
    leaves = []
    lm_mod.tree_map(lambda t: leaves.append(
        (t.to_local() if is_dtensor(t) else t)), tree)
    return sum(t.numel() * t.element_size() for t in leaves)


def _dist_moe(dev, n: int, arch: str, make: str, tokens) -> dict:
    """One MoE layer of ``arch`` (``make`` width) in bf16 from a seed,
    expert-parallel on a ``("model",)`` mesh of the world, each rank
    holding only its E/n expert slice (the layer's whole tree is made,
    run unsharded, and freed; the rank keeps its slice, a plain tree whose
    expert leaves hold E/n experts), against the layer unsharded on this
    rank: the largest differences, ms of each, the all-reduce's bytes a
    call, this rank's and the whole layer's parameter bytes, and the
    card's peak while the sliced layer runs."""
    cfg = getattr(get_arch(arch), make)()
    mcfg = next(b.moe for g in cfg.groups for b in g.cycle
                if b.ffn == "moe")
    p = moe_mod.moe_init(make_generator(11, dev), mcfg,
                         dtype=torch.bfloat16)
    rows, L = tokens
    x = torch.randn((rows, L, mcfg.d_model), generator=make_generator(
        12, dev), device=dev).to(torch.bfloat16)
    sm = dataclasses.replace(mcfg, dispatch="shardmap")
    mesh = init_device_mesh(mesh_device_type(), (n,),
                            mesh_dim_names=("model",))
    group = mesh.get_group("model")
    whole_bytes = _weights_bytes(p)
    with torch.no_grad():
        want = moe_mod.moe_apply(p, mcfg, x)
        torch.distributed.barrier()
        plain_ms = (_event_ms(dev, lambda: moe_mod.moe_apply(p, mcfg, x))
                    if torch.distributed.get_rank() == 0 else None)
        torch.distributed.barrier()
        mine = moe_mod.expert_slice(p, mesh)
        del p
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            got = moe_mod.moe_apply(mine, sm, x)
            ms = _event_ms(dev, lambda: moe_mod.moe_apply(mine, sm, x))
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        y = torch.zeros_like(want[0]).reshape(-1, mcfg.d_model)
        allreduce_ms = _event_ms(dev, lambda: moe_mod._all_reduce(y, group))
    err = _allclose_err(got[0].float(), want[0].float(),
                        TOL[torch.bfloat16], f"{arch} MoE layer, {n} ranks")
    aux_err = abs(float(got[1]) - float(want[1]))
    require(aux_err <= TOL[torch.float32] * max(1.0, abs(float(want[1]))),
            f"{arch} MoE aux: {float(got[1])} against {float(want[1])}")
    return {"arch": arch, "make": make, "d_model": mcfg.d_model,
            "d_ff": mcfg.d_ff, "experts": mcfg.n_experts,
            "top_k": mcfg.top_k, "shared": mcfg.n_shared,
            "experts_per_rank": mine["up"].shape[0], "tokens": rows * L,
            "y_max_abs_err": err, "aux_abs_err": aux_err,
            "ms": ms, "unsharded_ms": plain_ms,
            "allreduce_ms": allreduce_ms,
            "allreduce_bytes": rows * L * mcfg.d_model * 2 + 4,
            "param_bytes_per_rank": _weights_bytes(mine),
            "param_bytes_unsharded": whole_bytes,
            "peak_gb_sliced_layer": peak}


def _dist_lm(dev, n: int, arch: str, make: str, tokens) -> dict:
    """``arch``'s forward with ``PerfOpts(moe_shardmap=True)``'s config on
    a ``("model",)`` mesh of the world against the unsharded forward, f32
    compute (plain tensors: each rank holds its slice of the experts)."""
    cfg = getattr(get_arch(arch), make)()
    params = lm_mod.lm_init(make_generator(0, dev), cfg)
    tok = torch.randint(0, cfg.vocab, tokens,
                        generator=torch.Generator().manual_seed(13)).to(dev)
    mesh = init_device_mesh(mesh_device_type(), (n,),
                            mesh_dim_names=("model",))
    with torch.no_grad():
        want, aux = lm_mod.lm_forward(params, cfg, tok,
                                      compute_dtype=torch.float32)
        mine = moe_mod.expert_slice(params, mesh)
        del params
        with use_mesh(mesh):
            got, aux_sm = lm_mod.lm_forward(
                mine, steps_mod._apply_moe_shardmap(cfg), tok,
                compute_dtype=torch.float32)
    require(bool(torch.isfinite(got).all()), f"{arch}: non-finite logits")
    err = _allclose_err(got, want, TOL[torch.float32],
                        f"{arch} forward, moe_shardmap on {n} ranks")
    return {"arch": arch, "make": make, "tokens": list(tokens),
            "logits_max_abs_err": err,
            "aux_abs_err": abs(float(aux_sm) - float(aux))}


class _KernelHeads:
    """Records, for the duration, the shape of every flash_attention and
    ssd_scan call (``ops``' wrappers, which the attention and SSM layers
    reach as ``kops.<name>``): (B, L, H, Hkv, D) and (B, L, H, P, G, N,
    chunk), the heads those of the call's own tensors."""

    def __enter__(self):
        self.calls = {"flash_attention": [], "ssd_scan": []}
        self.orig = (ops.flash_attention, ops.ssd_scan)
        fa, ss = self.orig

        def flash(q, k, v, **kw):
            self.calls["flash_attention"].append(
                tuple(q.shape[:3]) + (k.shape[2], q.shape[3]))
            return fa(q, k, v, **kw)

        def ssd(x, dt, A, Bm, Cm, D, *, chunk, **kw):
            self.calls["ssd_scan"].append(
                tuple(x.shape) + tuple(Bm.shape[2:]) + (chunk,))
            return ss(x, dt, A, Bm, Cm, D, chunk=chunk, **kw)
        ops.flash_attention, ops.ssd_scan = flash, ssd
        return self

    def __exit__(self, *exc):
        ops.flash_attention, ops.ssd_scan = self.orig


def _serve_run(params, cfg, tok, dec, S: int, mesh=None) -> list:
    """The serving steps the prefill and decode bundles run (``lm_prefill``
    through the kernels, then one ``lm_decode`` a column of ``dec``), bf16
    compute, on ``mesh`` where given (the cache a DTensor by
    ``lm_cache_spec``, the tokens by the batch axes).  Returns every
    step's logits as f32 (whole)."""
    B, L = tok.shape
    cache = lm_mod.lm_init_cache(cfg, B, S, dtype=torch.bfloat16,
                                 device=tok.device)
    with torch.no_grad(), use_mesh(mesh):
        if mesh is not None:
            cache = steps_mod.shard_tree(cache, lm_mod.lm_cache_spec(cfg),
                                         mesh)
            tok, dec = (shard_spec(t, steps_mod.batch_spec_for(mesh, None),
                                   mesh) for t in (tok, dec))
        logits, cache = lm_mod.lm_prefill(params, cfg, tok, cache,
                                          impl="kernel")
        out = [logits]
        for i in range(dec.shape[1]):
            logits, cache = lm_mod.lm_decode(params, cfg, dec[:, i:i + 1],
                                             cache, L + i)
            out.append(logits)
    return [(t.full_tensor() if is_dtensor(t) else t).float() for t in out]


def _dist_lm_serve(dev, n: int, shape, arch: str, kernel: str, prompts,
                   n_decode: int, make: str = "make_full") -> dict:
    """``arch`` at ``make``'s width (full on the card), f32 weights from a seed: a prefill of
    ``prompts`` (rows x length) and ``n_decode`` decode tokens on a
    ``("data", "model")`` mesh of ``shape`` over the world, against the
    same steps unsharded in this process (LM_PREFILL_TOL of the largest
    logit, each step), and equal argmaxes where the unsharded top-2 margin
    is wide.  The sharded run's launches of ``kernel`` (counts reset just
    before, read just after) and the heads of each call, which must be
    this rank's: (H / model, Hkv / model) where "model" divides them.
    Also this rank's weight bytes beside the unsharded."""
    cfg = getattr(get_arch(arch), make)()
    params = lm_mod.lm_init(make_generator(0, dev), cfg)
    gen = torch.Generator().manual_seed(21)
    tok = torch.randint(0, cfg.vocab, prompts, generator=gen).to(dev)
    dec = torch.randint(0, cfg.vocab, (prompts[0], n_decode),
                        generator=gen).to(dev)
    S = prompts[1] + n_decode
    want = _serve_run(params, cfg, tok, dec, S)
    mesh = init_device_mesh(mesh_device_type(), shape,
                            mesh_dim_names=("data", "model"))
    sp = steps_mod.shard_tree(params, lm_mod.lm_spec(cfg), mesh)
    whole = _weights_bytes(params)
    del params
    sync(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    with _KernelHeads() as rec:
        got = _serve_run(sp, cfg, tok, dec, S, mesh)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "ssd_scan")}
    grids = {k: ops.GRIDS[k] for k in launches}
    n_model, n_data = shape[1], shape[0]
    blk = cfg.groups[0].cycle[0]
    if kernel == "flash_attention":
        H, Hkv = blk.attn.n_heads, blk.attn.n_kv_heads
        mine = (H // n_model if H % n_model == 0 else H,
                Hkv // n_model if Hkv % n_model == 0 else Hkv)
        heads = {(c[2], c[3]) for c in rec.calls[kernel]}
    else:
        H = blk.ssm.n_heads
        mine = (H // n_model if H % n_model == 0 else H,)
        heads = {(c[2],) for c in rec.calls[kernel]}
    rows = {c[0] for c in rec.calls[kernel]}
    n_layers = cfg.n_layers
    if dev.type == "cuda":
        require(launches[kernel] == n_layers and sum(launches.values())
                == n_layers, f"{arch} on {shape}: launched {launches}, "
                f"expected {n_layers} {kernel}")
    require(heads == {mine}, f"{arch} on {shape}: {kernel} ran on heads "
            f"{heads}, this rank's are {mine}")
    require(rows == {prompts[0] // n_data}, f"{arch} on {shape}: {kernel}"
            f" ran on rows {rows}")
    errs, agree = [], 0
    for i, (g, w) in enumerate(zip(got, want)):
        require(bool(torch.isfinite(g).all()), f"{arch} on {shape}: "
                f"non-finite logits at step {i}")
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        require(err <= LM_PREFILL_TOL * scale, f"{arch} on {shape}, step "
                f"{i}: logits differ by {err} > {LM_PREFILL_TOL} x {scale}")
        errs.append(err / scale)
        top2 = w.topk(2, dim=-1).values
        wide = (top2[..., 0] - top2[..., 1]) >= 0.05
        agree += int(((g.argmax(-1) == w.argmax(-1)) | ~wide).all())
    require(agree == len(got), f"{arch} on {shape}: argmax differs where "
            "the unsharded margin is >= 0.05")
    diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    by_shape = _sum_by_key([{_shape_key(c): 1} for c in rec.calls[kernel]])
    return {"arch": arch, "mesh": list(shape), "prompts": list(prompts),
            "decode_tokens": n_decode, "launches": launches,
            "grids": grids, "launches_by_shape": {kernel: by_shape},
            "heads_per_call": sorted(heads), "rows_per_call": sorted(rows),
            "max_rel_err": max(errs), "rel_err_by_step": errs,
            "max_abs_diff": max(diffs), "bit_for_bit": max(diffs) == 0.0,
            "first_step_differing": next((i for i, d in enumerate(diffs)
                                          if d), None),
            "tolerance_rel": LM_PREFILL_TOL, "wall_s": wall,
            "weight_bytes_per_rank": _local_bytes(sp),
            "weight_bytes_unsharded": whole}


def _dist_fsdp(dev, n: int, arch: str, steps: int, batch: int,
               seq_len: int, lr: float, smoke: bool = False) -> dict:
    """``steps`` train steps of ``arch`` at full width with
    ``PerfOpts(fsdp=True)`` on a (n, 1) ``("data", "model")`` mesh, each
    rank its shard of the parameters and moments, against ``train_loop``
    unsharded in this process (the same seed, batches and schedule): the
    losses, and every parameter leaf's update (after the steps less the
    init) by relative L2 (DIST_FSDP_TOL, bf16 compute), so a leaf left
    unchanged fails; in a world of one (every redistribution a no-op),
    the losses and leaves bit for bit."""
    want_p, _, want_h = train_loop(arch, smoke=smoke, steps=steps,
                                   batch=batch, seq_len=seq_len, lr=lr,
                                   log_every=0, device=dev)
    want = [t.detach() for t in lm_mod.tree_leaves(want_p)]
    del want_p
    mesh = init_device_mesh(mesh_device_type(), (n, 1),
                            mesh_dim_names=("data", "model"))
    arch_o, cfg, sched, _, _, batch_fn = train_setup(
        arch, smoke=smoke, steps=steps, batch=batch, seq_len=seq_len,
        lr=lr, device=dev)
    from repro_torch.launch.train import make_train_fns
    init_fn, step = make_train_fns(arch_o, cfg, lr_schedule=sched,
                                   opts=PerfOpts(fsdp=True), mesh=mesh)
    params, opt = init_fn(make_generator(0, dev))
    data = torch.Generator().manual_seed(0)
    hist = []
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = step(params, opt, batch_fn(data))
        hist.append({k: float(v) for k, v in m.items()})
    sync(dev)
    wall = time.perf_counter() - t0
    init = lm_mod.tree_leaves(train_setup(
        arch, smoke=smoke, steps=steps, batch=batch, seq_len=seq_len,
        lr=lr, device=dev)[3](make_generator(0, dev))[0])
    rel, diff = [], []
    for t, w, i in zip(lm_mod.tree_leaves(params), want, init):
        g, w, i = t.detach().full_tensor().float(), w.float(), i.float()
        moved = (w - i).norm().item()
        require(moved > 0, f"{arch}: train_loop left a leaf unchanged")
        rel.append((g - w).norm().item() / moved)
        diff.append((g - w).abs().max().item())
    del init
    require(max(rel) <= DIST_FSDP_TOL, f"{arch} FSDP: a leaf's update "
            f"differs by {max(rel)} (relative L2) from train_loop's")
    loss_rel = [abs(h["loss"] - w["loss"]) / abs(w["loss"])
                for h, w in zip(hist, want_h)]
    require(max(loss_rel) <= BF16_LOSS_TOL, f"{arch} FSDP: losses "
            f"{[h['loss'] for h in hist]} against "
            f"{[w['loss'] for w in want_h]}")
    if n == 1:
        require(max(diff) == 0.0 and max(loss_rel) == 0.0, f"{arch} FSDP "
                f"on (1, 1): leaves differ by up to {max(diff)}, losses by "
                f"{max(loss_rel)} (relative) from train_loop's")
    return {"arch": arch, "mesh": [n, 1], "steps": steps, "batch": batch,
            "seq_len": seq_len, "losses": [h["loss"] for h in hist],
            "unsharded_losses": [w["loss"] for w in want_h],
            "loss_max_rel_err": max(loss_rel),
            "update_max_rel_l2": max(rel), "leaf_max_abs_diff": max(diff),
            "leaves": len(rel), "tolerance_update_rel_l2": DIST_FSDP_TOL,
            "wall_s": wall,
            "param_bytes_per_rank": _local_bytes(params),
            "moment_bytes_per_rank": _local_bytes([opt["mu"], opt["nu"]]),
            "param_bytes_unsharded": sum(w.numel() * w.element_size()
                                         for w in want)}


def _dist_rank(rank: int, n: int, spec: dict) -> dict:
    """One rank of a phase-dist world: the sharded training, then, where
    ``spec`` asks, the MoE layer and the LM forward on a ``("model",)``
    mesh of the same ranks, the LM's mesh half (tensor-parallel serving,
    FSDP training) on ``("data", "model")`` meshes, or, in a world of
    one, the serving steps on a (1, 1) mesh against the unsharded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(spec["device"])
    out = ({"train": _dist_train(dev, rank, n, spec["env"], spec["B"],
                                 spec["episodes"])}
           if spec.get("train", True) else {})
    if spec.get("moe"):
        out["moe"] = _dist_moe(dev, n, *spec["moe"])
    if spec.get("lm"):
        out["lm"] = _dist_lm(dev, n, *spec["lm"])
    if spec.get("serve"):
        out["serve"] = [_dist_lm_serve(dev, n, (1, n), arch, kernel,
                                       spec["prompts"], spec["decode"],
                                       spec["make"])
                        for arch, kernel in spec["serve"]]
    if spec.get("fsdp"):
        out["fsdp"] = _dist_fsdp(dev, n, **spec["fsdp"])
    return out


def _run_examples(dev, examples: dict, timeout_s: float) -> dict:
    """The example twins as subprocesses at once, each with its reduced
    arguments and ``--device``, in a scratch directory (the checkpoint
    one writes lands there): each must exit 0 and print only finite
    numbers."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = {}
    with tempfile.TemporaryDirectory() as cwd:
        procs = {name: subprocess.Popen(
            [sys.executable, str(REPO / "examples" / f"{name}.py"), *args,
             "--device", str(dev)], cwd=cwd, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for name, args in examples.items()}
        t0 = time.perf_counter()
        try:
            for name, p in procs.items():
                left = max(timeout_s - (time.perf_counter() - t0), 1.0)
                stdout, stderr = p.communicate(timeout=left)
                require(p.returncode == 0, f"example {name} exited "
                        f"{p.returncode}: {stderr[-2000:]}")
                nums = [float(t) for t in re.findall(
                    r"-?\d+\.\d+|-?\bnan\b|-?\binf\b", stdout)]
                require(nums and all(math.isfinite(v) for v in nums),
                        f"example {name}: non-finite or no results")
                out[name] = {"args": examples[name], "numbers": len(nums),
                             "wall_s": time.perf_counter() - t0,
                             "last_line": stdout.strip().splitlines()[-1]}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
    return out


def phase_dist(device, env_cfg: EnvCfg = EnvCfg(), B: int = DIST_B,
               episodes: int = DIST_EPISODES, moe=DIST_MOE,
               moe_tokens=DIST_MOE_TOKENS, lm=DIST_LM,
               lm_tokens=DIST_LM_TOKENS, examples=DIST_EXAMPLES,
               timeout_s: float = DIST_TIMEOUT_S, card: str = "",
               serve=DIST_SERVE, prompts=DIST_PROMPTS, decode=DIST_DECODE,
               make: str = "make_full", fsdp=DIST_FSDP) -> dict:
    """The port's multi-device path (``card``: nvidia-smi's name and power
    limit, reported beside the numbers).  In this process:
    ``run_training`` of B fused cells (``method_cfg``'s t2drl settings) for
    ``episodes``, launches counted, then again with one intra-op thread
    (as every rank runs; the same bits, its wall s).  Then a world of one
    rank (NCCL on the
    card, gloo on the CPU) and a world of two gloo ranks (both on the one
    card: NCCL refuses two ranks on one device), each started by
    ``spawn_ranks`` with a deadline, run ``run_training_sharded`` of the
    same B cells (after a warm-up run from other seeds): every rank's
    state and history bit for bit this process's (sha256 of every leaf),
    its launches of ddpm_chain and ddpm_chain_bwd exactly this process's
    (one chain an acting slot, 2 + 1 a stacked update, whatever B); wall
    s per episode, the gather's bytes and ms, and the raw collective's ms
    on as many bytes.  The world of two also runs one ``moe`` MoE layer
    in bf16 expert-parallel on a ``("model",)`` mesh against the layer
    unsharded (2e-2; ms of each, the unsharded one on rank 0 alone, and
    of the all-reduce alone), and the ``lm`` forward with
    ``PerfOpts(moe_shardmap=True)``'s config against the unsharded one
    (f32, 2e-5), each rank holding its slice of the experts.  The world of
    one runs the LM's mesh half on a (1, 1) mesh: the ``serve`` models'
    prefill and ``decode`` steps (``_dist_lm_serve``) and ``fsdp``'s train
    steps (``_dist_fsdp``).  Then the example twins run with their reduced
    arguments.  The kernels are built before (phase build), so no rank
    runs nvcc."""
    dev = resolve_device(device)
    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = method_cfg("d3pg", "ddqn", env_cfg, episodes)
    gens = cell_generators(cfg.seed, B, dev)
    (ts, hist), run = _timed_run(dev, lambda cb: run_training(
        t2drl_init_batch(gens, cfg), cfg, gens, episodes, callback=cb))
    n_upd = ts["d3pg"]["opt_a"]["step"]
    require(n_upd == sum(u for u, _ in predicted_updates(cfg, episodes)),
            f"run_training: {n_upd} updates")
    want = {"ddpm_chain": env_cfg.T * env_cfg.K * episodes + 2 * n_upd,
            "ddpm_chain_bwd": n_upd}
    single = {k: run["launches"][k] for k in DIST_TRAIN_KERNELS}
    if dev.type == "cuda":
        require(single == want, f"run_training launched {single}, "
                f"expected {want}")
    digest = _state_digest(ts)
    del ts
    # the same run with one intra-op thread, as every rank runs: the
    # host-bound episode's cost of the thread pool on the host's small ops
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gens = cell_generators(cfg.seed, B, dev)
    try:
        (ts, hist1), run1 = _timed_run(dev, lambda cb: run_training(
            t2drl_init_batch(gens, cfg), cfg, gens, episodes, callback=cb))
    finally:
        torch.set_num_threads(threads)
    require(_state_digest(ts) == digest and hist1 == hist,
            "run_training with one intra-op thread differs")
    del ts
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    spec = {"device": str(dev), "env": env_cfg, "B": B,
            "episodes": episodes, "prompts": tuple(prompts),
            "decode": decode}
    mesh_half = {"serve": serve, "make": make,
                 "fsdp": {**fsdp, "smoke": make != "make_full"}}
    worlds = {}
    for n, backend, extra in (
            (1, "nccl" if dev.type == "cuda" else "gloo", mesh_half),
            (2, "gloo", {"moe": (*moe, moe_tokens), "lm": (*lm, lm_tokens)})):
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dist_rank, n, args=({**spec, **extra},),
                            backend=backend, device_type=dev.type,
                            timeout_s=timeout_s)
        world = {"ranks": n, "backend": backend,
                 "seconds": time.perf_counter() - t0}
        for r in ranks:
            tr = r["train"]
            bad = sorted(k for k in digest if tr["digest"].get(k)
                         != digest[k])
            require(not bad and set(tr["digest"]) == set(digest),
                    f"{n} ranks, rank {tr['rank']}: leaves differ from "
                    f"run_training's: {bad[:6]}")
            require(tr["history"] == hist, f"{n} ranks, rank {tr['rank']}: "
                    "history differs from run_training's")
            require(tr["launches"] == single, f"{n} ranks, rank "
                    f"{tr['rank']} launched {tr['launches']}, run_training "
                    f"{single}")
            del tr["digest"], tr["history"]
        world["train"] = [r["train"] for r in ranks]
        for k in ("moe", "lm", "serve", "fsdp"):
            if k in ranks[0]:
                world[k] = [r[k] for r in ranks]
        worlds[str(n)] = world
    for k, what in (("moe", "y_max_abs_err"), ("lm", "logits_max_abs_err")):
        vals = [w[what] for w in worlds["2"][k]]
        require(max(vals) == min(vals), f"the ranks' {k} differ: {vals}")
    ex = _run_examples(dev, examples, timeout_s)
    Bl = B // 2
    served = [r for rank in worlds["1"]["serve"] for r in rank]
    lm_by_shape = {k: _sum_by_key([r["launches_by_shape"].get(k, {})
                                   for r in served])
                   for k in ("flash_attention", "ssd_scan")}
    f1, m2 = worlds["1"]["fsdp"][0], worlds["2"]["moe"]
    per_rank_bytes = {
        **{f"{r['arch']} serve {r['mesh']}": {
            "weights_per_rank": r["weight_bytes_per_rank"],
            "weights_unsharded": r["weight_bytes_unsharded"]}
           for r in served},
        f"{f1['arch']} fsdp {f1['mesh']}": {
            "params_per_rank": f1["param_bytes_per_rank"],
            "moments_per_rank": f1["moment_bytes_per_rank"],
            "params_unsharded": f1["param_bytes_unsharded"]},
        f"{moe[0]} MoE layer, model 2": {
            "params_per_rank": [r["param_bytes_per_rank"] for r in m2],
            "params_unsharded": m2[0]["param_bytes_unsharded"],
            "peak_gb_sliced_layer": [r["peak_gb_sliced_layer"]
                                     for r in m2]}}
    return {"phase": "dist", "card": card, "B": B, "episodes": episodes,
            "leaves": len(digest), "d3pg_updates": n_upd,
            "single_process": {"wall_s": run["wall_s"],
                               "wall_s_per_episode": run["wall_s"]
                               / episodes, "threads": threads,
                               "launches": single},
            "single_process_one_thread": {
                "wall_s": run1["wall_s"],
                "wall_s_per_episode": run1["wall_s"] / episodes},
            "worlds": worlds, "examples": ex,
            "launches_by_shape": {
                "ddpm_chain": {
                    f"B{B}_R1": want["ddpm_chain"] - 2 * n_upd,
                    f"B{B}_R64": n_upd, f"B{B}_R64+record": n_upd,
                    f"B{Bl}_R1": 2 * (want["ddpm_chain"] - 2 * n_upd),
                    f"B{Bl}_R64": 2 * n_upd,
                    f"B{Bl}_R64+record": 2 * n_upd},
                "ddpm_chain_bwd": {f"B{B}_R64": n_upd,
                                   f"B{Bl}_R64": 2 * n_upd},
                **lm_by_shape},
            "lm_grids": {k: sum(r["grids"][k] for r in served)
                         for k in ("flash_attention", "ssd_scan")},
            "per_rank_bytes": per_rank_bytes,
            "grids": {k: sum(t["grids"][k] for w in worlds.values()
                             for t in w["train"])
                      for k in DIST_TRAIN_KERNELS},
            "reduced": [
                f"training: {episodes} episodes of {B} cells (of 500)",
                f"MoE: one {moe[0]} layer ({moe[1]}) on {moe_tokens[0]} x "
                f"{moe_tokens[1]} tokens; each rank holds its slice of the "
                "experts",
                f"LM mesh half on the card: the world of one, a (1, 1) mesh "
                f"({', '.join(a for a, _ in serve)} at {make}: "
                f"{prompts[0]} prompts of {prompts[1]}, {decode} decode "
                f"tokens; {fsdp['arch']} {fsdp['steps']} FSDP steps at "
                f"{fsdp['batch']} x {fsdp['seq_len']}); the two-rank "
                "meshes run in the CPU tests (gloo does not carry "
                "DTensor's CUDA collectives: scripts/probe_gloo_cuda.py)",
                f"LM: {lm[0]} at {lm[1]} width, one forward",
                *(f"example {k}: {' '.join(v)}" for k, v in
                  examples.items())],
            "seconds": time.perf_counter() - t_phase}


def modal_bucket(counts: dict) -> int:
    """The most frequent prefill length (the larger on a tie)."""
    return max((c, int(b)) for b, c in counts.items())[1]


_TIMES = ("ms", "graph_ms", "plain_ms", "bound_ms", "library_ms",
          "grids_per_call")


def kernel_summary(rows: list, launches_by_shape: dict, modal,
                   long_shapes, path_grids: int) -> dict:
    """One kernel's entry of the ``kernels`` line from its timing rows
    (``(key, row)`` pairs): the times at the modal shape, ``path_ms`` and
    ``path_bound_ms`` (launches times ms or bound, summed over the shapes
    the serving path ran), the times at ``long_shapes``, and
    ``grids_per_call``: ``path_grids``, the grids the serving path's
    launches started, over those launches.  ``path_grids`` must equal the
    launches of each shape times the grids one timed call there
    started."""
    by = {str(k): r for k, r in rows}
    out = {k: by[str(modal)][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "graph_ms", "shape")}
    path = []
    for shape, n in sorted(launches_by_shape.items()):
        r = by[str(shape)]
        path.append({"shape": r["shape"], "launches": n, "ms": r["ms"],
                     "graph_ms": r["graph_ms"], "bound_ms": r["bound_ms"],
                     "plain_ms": r["plain_ms"],
                     "library_ms": r.get("library_ms"),
                     "grids_per_call": r["grids_per_call"]})
    out["path"] = path
    timed = sum(p["launches"] * p["grids_per_call"] for p in path)
    require(path_grids == timed, f"the serving path started {path_grids} "
            f"grids; its shapes' timed calls make {timed}")
    out["grids_per_call"] = path_grids / sum(launches_by_shape.values())
    out["path_ms"] = sum(p["launches"] * p["ms"] for p in path)
    out["path_graph_ms"] = sum(p["launches"] * p["graph_ms"] for p in path)
    out["path_bound_ms"] = sum(p["launches"] * p["bound_ms"] for p in path)
    out["at"] = {str(k): {"shape": by[str(k)]["shape"],
                          **{t: by[str(k)][t] for t in _TIMES}}
                 for k in long_shapes}
    return out


# -- main -----------------------------------------------------------------------

def _shape_key(shape) -> str:
    return "x".join(map(str, shape))


REPLACES = {
    "ddpm_step": "src/repro/kernels/ddpm_step.py:20",
    "ddpm_step_bwd": "src/repro/kernels/ddpm_step.py:20 (its VJP, which "
                     "jax.grad derives through the sampler, "
                     "src/repro/diffusion/sampler.py:22)",
    "ddpm_chain": "src/repro/kernels/ddpm_step.py:20 with the lax.scan of "
                  "src/repro/diffusion/sampler.py:26",
    "ddpm_chain_bwd": "src/repro/kernels/ddpm_step.py:20 with the lax.scan "
                      "of src/repro/diffusion/sampler.py:26 (its VJP, which "
                      "jax.grad derives through the scan)",
    "flash_attention": "src/repro/kernels/flash_attention.py:27",
    "flash_mla": "none: src/repro/nn/mla.py runs MLA's attention as "
                 "einsums (no Pallas kernel)",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:22"}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
SOURCES["ddpm_step_bwd"] = SOURCES["ddpm_step"]
SOURCES["ddpm_chain_bwd"] = SOURCES["ddpm_chain"]
SOURCES["flash_mla"] = SOURCES["flash_attention"]


def _vector_paths(vector, kernel: str) -> tuple:
    """The vector-env phase's launches of ``kernel`` by timing case, summed
    over its fused, shared and population runs, and the grids they
    started."""
    runs = [vector[k] for k in ("fused", "shared", "population")]
    by = {}
    for r in runs:
        for case, n in r["launches_by_shape"][kernel].items():
            by[case] = by.get(case, 0) + n
    return by, sum(r["grids"][kernel] for r in runs)


def flash_mla_summary(archs, rows: list) -> dict:
    """flash_mla's entry of the ``kernels`` line: phase lm_archs' launches
    by shape (deepseek-v2's prefills), timed in ``rows`` (phase
    arch_timing's), the modal shape theirs, the times at DeepSeek's heads
    at the shortest and longest of ``MLA_TIMING_L`` under ``at``, and the
    MLA prefills that ran the plain products instead."""
    path = archs["launches_by_shape"]["flash_mla"]
    out = kernel_summary(
        [(_shape_key(r["shape"]), r) for r in rows], path,
        max(path, key=lambda k: (path[k], k)),
        [_shape_key((1, L) + MLA_HEADS) for L in (MLA_TIMING_L[0],
                                                  MLA_TIMING_L[-1])],
        archs["grids"]["flash_mla"])
    out["launches_by_phase"] = {"lm_archs": sum(path.values())}
    out["plain_mla_prefills"] = archs["plain_mla_prefills"]
    return out


def kernels_line(check, timing, train, control, data, lm, vector,
                 ops_run, fleet, archs, arch_timing, lm_train,
                 dist) -> dict:
    """The ``kernels`` line.  ddpm_step: the control plane's impl="step"
    episode (at (20,)) and the impl="step" updates of the train phase's
    update timing (their policy chains, at (64, 20)).  ddpm_step_bwd:
    those updates' policy gradients (at (64, 20)).  ddpm_chain: the modal
    shape is the control plane's chain (R = 1); the path sums the control
    plane's and the training run's launches (acting at R = 1, each
    update's target chain at R = 64 and its policy chain with the record
    at R = 64); the data plane's chains vary in L (their times are under
    "at"); grids per call over every plane.  ddpm_chain_bwd: the training
    run's policy gradients (R = 64), with the forward + backward of a
    policy chain through the chain and the step path under ``fwd_bwd``.
    flash_attention and ssd_scan at the most frequent prefill length of
    the LM plane, with the path summed over its buckets (24 launches per
    prefill) and the times at L = 512 and 4096 beside it.  Every kernel
    must have launched on its path.  The vector-env phase adds its
    launches to ddpm_chain's and ddpm_chain_bwd's paths at their shapes
    (the stacked ones under ``at`` with their B single-learner
    yardstick, ``single_x_B_ms``); the ops phase (its cachers, scenarios,
    checkpoint and telemetry runs) adds its launches alike, and so does
    the fleet phase (one chain a slot at R = 64, and at R = 1 for its
    one-cell run).  flash_attention's and ssd_scan's paths add phase
    lm_archs' launches by shape (every architecture's heads), timed in
    phase arch_timing with SDPA beside flash; the modal shape is taken
    over both LM phases.  Phase lm_train adds the launches of serving its
    two trained checkpoints (qwen2-0.5b's and mamba2-130m's heads, at
    shapes phase kernel_timing times); its training launches none.  Phase
    dist adds its ranks' launches of the two chain kernels (the sharded
    training's, at the B = 8 and B = 4 stacked shapes), and of
    flash_attention and ssd_scan (the LM mesh half's prefills, at the
    shapes phase dist_timing times), under ``launches_by_phase``.
    flash_mla (flash_attention at MLA's head pair (192, 128)): phase
    lm_archs' launches (deepseek-v2's prefills), timed in phase
    arch_timing with SDPA beside it, its modal shape theirs, with the
    times at DeepSeek's heads at L = 512 and 4096 under ``at``; the MLA
    prefills that ran the plain products instead under
    ``plain_mla_prefills``."""
    step_run = control["chain_vs_step_episode"]["step"]
    tl = train["launches"]
    upd = train["update_timing"]
    step_upd = upd["step"]
    step_rows = [(_shape_key(r["shape"]), r) for r in timing["ddpm_step"]]
    step_path = {"20": step_run["launches"]["ddpm_step"],
                 "64x20": step_upd["launches"]["ddpm_step"]}
    summary = {"ddpm_step": kernel_summary(
        step_rows, step_path, max(step_path, key=step_path.get),
        ("20", "256", "65536x256"),
        step_run["grids"] + step_upd["grids"]["ddpm_step"])}
    summary["ddpm_step"]["launches_by_path"] = {
        "control_step_episode": step_path["20"],
        "step_updates": step_path["64x20"]}
    summary["ddpm_step_bwd"] = kernel_summary(
        [(_shape_key(r["shape"]), r) for r in timing["ddpm_step_bwd"]],
        {"64x20": step_upd["launches"]["ddpm_step_bwd"]}, "64x20",
        ("20", "256", _shape_key(BWD_SHAPES[-1])),
        step_upd["grids"]["ddpm_step_bwd"])
    summary["ddpm_step_bwd"]["launches_by_path"] = {
        "step_updates": step_upd["launches"]["ddpm_step_bwd"]}
    chain_rows = [(r["case"], r) for r in timing["ddpm_chain"]
                  + timing["stacked"]["ddpm_chain"]]
    vec_chain, vec_grids = _vector_paths(vector, "ddpm_chain")
    ops_chain = ops_run["launches_by_shape"]["ddpm_chain"]
    ops_bwd = ops_run["launches_by_shape"]["ddpm_chain_bwd"]
    ops_grids = ops_run["grids"]
    by_plane = {"control": control["launches"]["ddpm_chain"],
                "train": tl["ddpm_chain"],
                "data": data["launches"]["ddpm_chain"],
                "lm_gateway": lm["gateway"]["launches"]["ddpm_chain"],
                "vector": sum(vec_chain.values()),
                "ops": sum(ops_chain.values()),
                "fleet": sum(fleet["launches_by_shape"]["ddpm_chain"]
                             .values()),
                "dist": sum(dist["launches_by_shape"]["ddpm_chain"]
                            .values())}
    acting = train["env"]["T"] * train["env"]["K"] * train["episodes"]
    n_d3 = train["d3pg_updates"]
    chain_path = {"control": by_plane["control"] + acting,
                  "control_R64": n_d3, "control_R64+record": n_d3}
    for case, n in (list(vec_chain.items()) + list(ops_chain.items())
                    + list(fleet["launches_by_shape"]["ddpm_chain"]
                           .items())
                    + list(dist["launches_by_shape"]["ddpm_chain"]
                           .items())):
        chain_path[case] = chain_path.get(case, 0) + n
    chain = kernel_summary(
        chain_rows, chain_path, "control", [k for k, _ in chain_rows[1:]],
        control["grids"] + train["grids"]["ddpm_chain"] + vec_grids
        + ops_grids["ddpm_chain"] + fleet["grids"]["ddpm_chain"]
        + dist["grids"]["ddpm_chain"])
    chain["step_ms"] = timing["ddpm_chain"][0]["step_ms"]
    for k, row in chain_rows[1:]:
        if "step_ms" in row:
            chain["at"][k]["step_ms"] = row["step_ms"]
    chain["plans"] = timing["ddpm_chain_plans"]
    chain["launches_by_plane"] = by_plane
    chain["launches_by_phase"] = {"dist": by_plane["dist"]}
    chain["grids_per_call"] = (control["grids"] + data["grids"]
                               + train["grids"]["ddpm_chain"]
                               + lm["gateway"]["grids"]["ddpm_chain"]
                               + vec_grids + ops_grids["ddpm_chain"]
                               + fleet["grids"]["ddpm_chain"]
                               + dist["grids"]["ddpm_chain"]) \
        / sum(by_plane.values())
    chain["clusters_per_call"] = (control["clusters"] + data["clusters"]) \
        / (by_plane["control"] + by_plane["data"])
    summary["ddpm_chain"] = chain
    vec_bwd, vec_bwd_grids = _vector_paths(vector, "ddpm_chain_bwd")
    bwd_path = {"train": tl["ddpm_chain_bwd"]}
    dist_bwd = dist["launches_by_shape"]["ddpm_chain_bwd"]
    for case, n in (list(vec_bwd.items()) + list(ops_bwd.items())
                    + list(dist_bwd.items())):
        bwd_path[case] = bwd_path.get(case, 0) + n
    bwd = kernel_summary(
        [(r["case"], r) for r in timing["ddpm_chain_bwd"]
         + timing["stacked"]["ddpm_chain_bwd"]],
        bwd_path, "train", ("control_R1", "R1024")
        + tuple(r["case"] for r in timing["stacked"]["ddpm_chain_bwd"]),
        train["grids"]["ddpm_chain_bwd"] + vec_bwd_grids
        + ops_grids["ddpm_chain_bwd"] + dist["grids"]["ddpm_chain_bwd"])
    bwd["fwd_bwd"] = {r["case"]: r["fwd_bwd"]
                      for r in timing["ddpm_chain_bwd"]}
    bwd["launches_by_path"] = {
        "train": tl["ddpm_chain_bwd"], "vector": sum(vec_bwd.values()),
        "ops": sum(ops_bwd.values()), "dist": sum(dist_bwd.values()),
        "chain_updates": upd["chain"]["launches"]["ddpm_chain_bwd"]}
    bwd["launches_by_phase"] = {"dist": sum(dist_bwd.values())}
    summary["ddpm_chain_bwd"] = bwd
    launches = {"ddpm_step": sum(step_path.values()),
                "ddpm_step_bwd": step_upd["launches"]["ddpm_step_bwd"],
                "ddpm_chain": sum(by_plane.values()),
                "ddpm_chain_bwd": (tl["ddpm_chain_bwd"]
                                   + sum(vec_bwd.values())
                                   + sum(ops_bwd.values())
                                   + sum(dist_bwd.values())),
                "flash_attention": (lm["flash_attention_launches"]
                                    + archs["flash_attention_launches"]
                                    + lm_train["flash_attention_launches"]
                                    + sum(dist["launches_by_shape"]
                                          ["flash_attention"].values())),
                "ssd_scan": (lm["ssd_scan_launches"]
                             + archs["ssd_scan_launches"]
                             + lm_train["ssd_scan_launches"]
                             + sum(dist["launches_by_shape"]
                                   ["ssd_scan"].values())),
                "flash_mla": archs["flash_mla_launches"]}
    for kname, model, heads in (
            ("flash_attention", "qwen2-0.5b", QWEN_HEADS),
            ("ssd_scan", "mamba2-130m", MAMBA_SSD)):
        counts = lm["bucket_counts"][model]
        per_shape = _sum_by_key([
            {_shape_key((1, int(b)) + heads): lm["n_layers"][model] * c
             for b, c in counts.items()},
            archs["launches_by_shape"][kname],
            lm_train["launches_by_shape"][kname],
            dist["launches_by_shape"][kname]])
        require(sum(per_shape.values()) == launches[kname],
                f"{kname}: {launches[kname]} launches but the shapes "
                f"account for {sum(per_shape.values())}")
        rows = [(_shape_key(r["shape"]), r)
                for r in timing[kname] + arch_timing[kname]]
        summary[kname] = kernel_summary(
            rows, per_shape, max(per_shape, key=lambda k: (per_shape[k], k)),
            [_shape_key((1, L) + heads) for L in (512, LONG_L)],
            lm["grids"][kname] + archs["grids"][kname]
            + lm_train["grids"][kname] + dist["lm_grids"][kname])
        summary[kname]["launches_by_phase"] = {
            "lm_plane": (lm["flash_attention_launches"]
                         if kname == "flash_attention"
                         else lm["ssd_scan_launches"]),
            "lm_archs": sum(archs["launches_by_shape"][kname].values()),
            "lm_train": sum(lm_train["launches_by_shape"][kname].values()),
            "dist": sum(dist["launches_by_shape"][kname].values())}
    summary["flash_mla"] = flash_mla_summary(archs, arch_timing["flash_mla"])
    idle = [k for k, n in launches.items() if n <= 0]
    require(not idle, f"kernels never launched on their paths: {idle}")
    err = {k: max(([check[k]["max_abs_err"]] if k in check else []) + [
        r["max_abs_err"] for r in arch_timing.get(k, [])]) for k in launches}
    return {"kernels": [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k], "launches": launches[k],
        "max_abs_err": err[k], **summary[k]}
        for k in ("ddpm_step", "ddpm_step_bwd", "ddpm_chain",
                  "ddpm_chain_bwd", "flash_attention", "flash_mla",
                  "ssd_scan")]}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_info = phase_device()
    emit(dev_info)
    device = resolve_device()
    emit(phase_build())
    check = phase_kernel_check(device)
    emit(check)
    timing = phase_kernel_timing(device)
    emit(timing)
    train = phase_train(device)
    emit(train)
    vector = phase_vector(device)
    emit(vector)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ops_run = phase_ops(device, card=dev_info["nvidia_smi"],
                            ckpt_dir=ckpt_dir)
        emit(ops_run)
        fleet = phase_fleet(device, ckpt=str(Path(ckpt_dir) / "t2drl.ckpt"))
        emit(fleet)
    control = phase_control_plane(device)
    emit(control)
    data = phase_data_plane(device)
    emit(data)
    lm = phase_lm_plane(device)
    emit(lm)
    archs = phase_lm_archs(device)
    emit(archs)
    arch_timing = phase_arch_timing(device, timing, archs, MLA_TIMING_L)
    emit(arch_timing)
    lm_train = phase_lm_train(device, card=dev_info["nvidia_smi"])
    emit(lm_train)
    dist = phase_dist(device, card=dev_info["nvidia_smi"])
    emit(dist)
    # timing rows of the shapes phase dist launched and no phase timed
    dist_timing = phase_arch_timing(
        device, {k: timing.get(k, []) + arch_timing[k]
                 for k in ("flash_attention", "flash_mla", "ssd_scan")},
        {"launches_by_shape": dist["launches_by_shape"]})
    emit({**dist_timing, "phase": "dist_timing"})
    arch_timing = {k: arch_timing[k] + dist_timing[k]
                   for k in ("flash_attention", "flash_mla", "ssd_scan")}
    emit(kernels_line(check, timing, train, control, data, lm, vector,
                      ops_run, fleet, archs, arch_timing, lm_train, dist))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
