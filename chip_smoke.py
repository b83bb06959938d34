"""Run the PyTorch port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py [--baseline-src DIR]

Phases (any failure exits non-zero):

1. build   — nvcc builds every CUDA source of the port (one process each,
             all at once) from src/repro_torch/csrc.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shape and at edge cases; the main path's shape
             is timed (CUDA events, median) beside its bound, the plain
             version and one PyTorch library call. K1 paged attention has
             one kernel (csrc/paged_attention_sm90.cu: pages split across
             blocks, query rows in group tiles, pages staged by bulk
             copies or the producer warp's loads) for every shape. It is
             held against the plain version at the serving shape, the
             kernel bench's shapes, GQA d=256 softcap bf16, GQA g=4 softcap
             bf16, lengths 0, 1 and on split boundaries, empty trailing
             splits, d=16 and a bad page id (NaN on its sequence only, at
             g=2 f32 and g=16 bf16), at several splits; at the shapes K1
             once refused or sent to an earlier kernel (g=9, MQA g=16,
             d=512 and 2048, 24-byte rows, 64 KiB pages, pages of 300 and
             512 keys, pools off 16-byte alignment) through the wrapper;
             and at published widths with eight or more query heads per
             kv head (PAGED_GROUP_SHAPES: Qwen3-235B-A22B, Mistral-Large-2,
             StarCoder and Falcon-7B, qwen1.5-110b's g=8, and d=512 g=2;
             B=32, page 16, 36 slots, f32, bf16 and f16): the mma route's
             main path (csrc/paged_attention_sm90.cu's tensor-core route,
             g >= 8 at d <= 256), its launches
             counted from 0, each plan's route printed and held to "mma"
             at g > 8; at g = 8 both routes timed in turns; with
             --baseline-src commit 076818b's K1 in turns at every group
             shape, the serving shape, the kernel bench's shapes and the
             wide route's (d split across the CTAs of a thread-block
             cluster; its cluster size and the card's most active such
             clusters printed). K1 is timed as one call between two CUDA
             events (``ms``, host work included, the kernels line's
             measure) and as device time per call from CUDA-graph replays
             (``device_ms``), at the chosen split and (device time) at one
             split, beside SDPA and the bound (bytes, or the flops where
             larger: f32 at the CUDA-core rate, on the mma route at the
             3xTF32 rate with the f32-rate figure beside it); with
             --baseline-src, the earlier CUDA-core kernel
             (csrc/paged_attention.cu) at the serving shape.
             K2 flash attention has two routes, by dtype: bf16 and f16 go
             to the 2-byte wgmma kernel (csrc/flash_attention_sm90.cu; TMA,
             or the producers' own loads where TMA cannot read a tensor),
             f32 to the 3xTF32 wgmma kernel (csrc/flash_attention_f32_sm90
             .cu); both take any head dim (past 256 in slices of the
             output). All three types are held against the plain version
             on the tests/test_kernels.py sweep, gemma2's widths (d=256,
             softcap 50), ragged tails, strided (B,S,H,d) views, rows that
             see no key (against each kernel's own tiles, at d=64 and 320)
             and d=288, 320, 512 and 1024; the f32 route also on k, v off
             16-byte alignment and d=37; the 2-byte route (bf16, f16) at
             d=37, 40, 72, 100 and 330, contiguous, 2 bytes off 16-byte
             alignment and as views of rows of d+1 (every own-load unit
             must run). At the forward shape (B=2, H=20, S=4096, d=128,
             causal) the bf16 kernel prints its TFLOP/s, registers, shared
             memory and spills beside SDPA; the same inputs in f16 are
             timed beside SDPA is_causal on them and the bound; then in f32
             they go through the f32 route, held against the plain version
             and a float64 plain run (the yardstick of f32 rounding), timed
             as one eager call and in device time from CUDA-graph replays
             beside SDPA on them, the earlier CUDA-core kernel (with
             --baseline-src), its bound at the 3xTF32 rate (the record's
             bound_ms) and at the f32 rate, with the f32 kernel's
             registers and spills. With --baseline-src holding commit
             076818b's sources, the bf16, f16 and f32 routes, K1 at the
             serving shape and K3 at the layer shape are timed in turns
             beside them (device ms). FLASH_SHAPES times d=256, d=512,
             d=1280, d=2304 and SigLIP-so400m's d=72 (by TMA and by the
             own loads) on every route, in turns with 076818b's where
             given; the f32 route past d = 256 (its cluster route: d in
             slices of 128 columns, or 256 at 1024 < d <= 2048, over a
             cluster of CTAs, S summed once over distributed shared
             memory; d=2304 past one cluster's reach) with its cluster
             size and the card's most active such clusters printed (the
             other slice width: benchmarks_torch/wide_variants.py). K1 and K3
             are also held in f16 (K1 at the serving shape and Qwen3-235B-
             A22B's group, K3 on the sweep and at the layer shape) and
             timed there. The shapes past the card's old limits are
             held against the plain versions and timed beside their
             bounds and SDPA: K1 at d = 2056-16,384 (the wide
             route), 65,543 sequences and 65,539 kv heads; K2 at 65,537 q
             tiles in bf16 (q past 2^31 elements), f16 and f32; K3 at chunk
             512 and 1024 and dh 520-1024, 4096 and 4100 (the cluster
             outputs pass), and at K3_WIDE_SHAPES (the xLSTM head widths
             dh = 768, 1024 and 1280 at B=8, H=4, S=2048, chunk 256, and
             dh=384 and 64 at chunk 512: f32, dh=1024 also bf16 and f16;
             each pass timed apart
             beside its 3xTF32 bound, the cluster size and the card's
             most active clusters), with --baseline-src in turns with
             commit 774e907's sliced outputs pass.
3. small   — the reduced models, kernel path on the card against the plain
             path on the CPU from the same weights: the serving example
             (same generated tokens) and a 2-layer Qwen forward with
             use_pallas (same logits and loss).
4. serve   — Qwen1.5-4B at full width and depth (random bf16 weights from
             a seed, float32 KV pools) served through the SMS scheduler and
             the paged allocator until at least 8 requests of both client
             kinds have finished. Every logit must be finite, K1 must have
             run once per layer per step, and one mid-run step is
             recomputed with the plain attention.
5. forward — the same weights, the pools freed: the full-sequence forward
             and loss (``get_model(cfg).train_loss`` with use_pallas, B=2,
             S=4096, bf16). The loss must be finite, K2 must have run once
             per layer per forward, every launch through the bf16 route,
             K2 at the first and last layer is held
             against the plain version, and the logits and loss against a
             forward with the plain attention. Then the same in float16
             and in float32 (``RunConfig(compute_dtype=..., use_pallas=
             True)``, all 40 layers): exactly 40 K2 launches per forward,
             all on that type's route, the first and last layers'
             attention at its tolerance (f16: atol 1e-3, rtol 2e-3), the
             logits against a plain-path run of the same type at that
             tolerance with the rtol of the largest |logit|; forward+loss
             ms (median of 3 after a warm-up), peak memory and one profiled
             forward. One function, ``phase_forward(params, ms, dtype)``,
             runs all three.
6. kernel bench — ``benchmarks_torch/kernel_bench.py``'s main: K1, K2 and
             K3 at the reference bench's sweeps against their plain
             versions, timed beside their bounds. It is K3's main path: the xLSTM model keeps its
             own chunk scan, as the reference does.
7. xlstm   — xLSTM-125m at full width and depth (random float32 weights
             from a seed, bf16 compute): ``get_model(cfg).train_loss`` at
             B=8, S=2048 timed; the loss finite and near ln(vocab); K3 on
             layer 1's own q, k, v and gates against the layer's chunk
             scan; ``prefill`` of S-1 tokens and 8 greedy ``decode_step``s,
             the first held against the forward's last position.
8. train   — the training path (src/repro_torch/{data,optim,train,
             checkpoint}, launch/train.py), which runs no hand-written
             kernel (K1-K3 launch 0 times in it): (a) reduced xLSTM (5
             layers) and Qwen (2 layers), f32: three train steps on the card
             against the same steps on the CPU from one set of weights and
             batches, then one microbatched and one top-k step; losses, grad
             norms, lr, every parameter, moment and error-feedback leaf (the
             parameters at atol 2e-5 + 0.1 lr per update, the reason
             printed); (b) xLSTM-125m at full width and depth through the
             reference launcher's settings (``launch/train.py``: B=8,
             S=512, f32, remat none, lr 3e-4), 8 steps with a checkpoint
             every 4: finite losses, the first within 0.5 of ln V, the last
             below it; a second Trainer restores step 4 and runs 4 more, its
             state must equal the continuous run's bit for bit (else at the
             parameter tolerance, the reason printed); median step ms,
             tokens/s, peak memory, and kernels per step and the idle share
             from a torch.profiler window over one step; (c) Qwen1.5-4B at
             full width, 8 of its 40 layers (f32 AdamW state at 40 layers
             is 63 GB before activations), B=1, S=2048, f32, remat full, 4
             steps: losses, step ms, tokens/s, peak memory, model TFLOP/s
             (6 N tokens per step) beside the f32 peak, kernels and idle
             share over one profiled step; then a step with use_pallas must
             raise the kernels' refusal of a gradient. It
             prints a JSON ``train`` record. The small runs (a) also take
             three steps of reduced moonshot (its loss adds 0.01 x the MoE
             aux) and hymba, card against CPU.
9. families — the model families (src/repro_torch/models/{moe,ssm,hymba,
             whisper}.py): the reduced moonshot, llama4-scout (top-1),
             hymba and whisper, f32, card against CPU (logits, aux, loss
             with use_pallas: K2's f32 route for MoE and for whisper's 64
             frames; prefill and 4 greedy decode steps, same tokens); K2 at
             moonshot's attention shape (B=1, H=16, S=4096, d=128, bf16,
             causal) beside its bound, the plain version and SDPA; then at
             full width and depth with random bf16 weights from a seed:
             moonshot-v1-16b-a3b (28.47 B parameters), B=1, S=4096,
             train_loss with use_pallas (K2 once per layer, bf16 route);
             K2 against its plain version on every layer's own q, k, v;
             every block, and so the logits, with the plain attention on
             the kernel forward's own input and expert choices at the bf16
             tolerance (rtol of the largest |value|): random weights grow
             the residual stream and amplify any rounding difference, and
             top-k routing flips at near ties, so free-running logits meet
             no bf16 bar; a free-running plain-attention forward: the loss
             at the bf16 tolerance, layer 0's chosen experts (equal
             wherever the router's k-th and (k+1)-th logits are more than
             1e-2 apart), the stream's drift per layer; hymba-1.5b, B=2,
             S=4096, use_pallas (K2 never launches); whisper-large-v3, 1,500
             frames and 448 decoder tokens, B=2, without use_pallas, then
             with it: the reference's block assertion at the first
             cross-attention, after one K2 launch. Each prints forward+loss
             ms (median of 3 after a warm-up), scored tokens/s, peak
             memory, a profiled forward (kernels, device ms, idle share),
             prefill ms and greedy decode ms per step over 8 steps.
10. sim    — the cycle simulator's main path (src/repro_torch/core), which
             runs no hand-written kernel (every kernel count stays 0). At
             the goldens' configuration: frfcfs, atlas, parbs, tcm, sms and
             sms_dash alone, and the stackable family (frfcfs, atlas,
             parbs, tcm, bliss, squash_prio) stacked, reproduce the sha1
             digests of tests/golden_policy_states.json (the stacked run
             slice by slice); sms at the knob points {} and dash=True on
             the folded step equals sms and sms_dash alone; each slice of
             a stacked grid with period and value overrides equals its run
             alone. Then the paper's 16 CPUs + 1 GPU on 4 channels of 8
             banks (the buffer at SMS's entry parity, 134 entries) over 14
             workloads and the 23 alone runs in one batch (W = 37), 100
             warm-up and 600 measured cycles: the six stackable policies
             in ONE stacked run on P*W = 222 rows, sms and sms_dash alone,
             and frfcfs alone, which must equal its stacked slice. Every
             result equals the same call on the CPU (a second process, run
             alongside); the timed loops run under
             torch.cuda.set_sync_debug_mode("error"). It prints WS, max
             slowdown, cpuWS and gpuSU per policy, SMS's WS gain and
             fairness over TCM beside the paper's Fig 4, slice-cycles/s on
             the card and the CPU, and kernels per cycle and the device
             idle share from a torch.profiler window. The variable-step
             driver, the sanitizer and the recorder: at the goldens'
             configuration the golden policies alone and the family
             stacked through skip=True (the sanitizer on, the stacked run
             the recorder too) reproduce the digests; all 15 counters stay
             0 for every policy ticked and skipping, solo and stacked; each
             of the five faults (core/faults.py) flips one of its TARGETS
             counters; the family stacked with the recorder on equals the
             run without in every other array, its invariant channels
             equal ticked and skipping. Then the paper's widths with two
             HWAs (16 CPUs + 1 GPU + 2 HWAs, 4 channels, 146 entries) under
             workloads.bursty_batch's four archetypes, 100 + 500 cycles:
             the stacked family and sms ticked (the archetypes as one W = 4
             batch, under the sync check) and skipping (each archetype a W
             = 1 batch; one host read per processed step, so timed without
             the sync check), one skipping run with the sanitizer and the
             recorder on. Skipping equals ticking in every metric but
             sim_steps, every run (sim_steps too) equals the CPU's, host
             reads equal processed steps. Per archetype it prints the skip
             ratio, processed steps, slice-cycles/s ticked and skipping,
             kernels per processed step and the idle share.

11. dist   — the distribution layer (src/repro_torch/distributed, the mesh
             paths of the models and steps, launch/{mesh,dryrun,dryrun_pp}),
             run before the sim phase: (a) NCCL at world 1 (a FileStore),
             a (1, 1) mesh: Qwen1.5-4B at full width, 8 of 40 layers, f32,
             B=1, S=2048, three sharded ``build_train_step`` steps against
             the unsharded ones from the same weights (losses at the f32
             bar, params at 2e-5 + 0.1 lr per update; bit-identity
             reported); the sharded prefill at full width and depth, B=1,
             S=4096, bf16, use_pallas: K2 once per layer on the local head
             shards, every launch on the bf16 route (its launches are in
             the kernels line), the logits against the unsharded prefill
             with the plain attention at the bf16 tolerance with the rtol of
             the largest |logit|; (b) 4 gloo ranks whose tensors all live on
             the card (NCCL refuses two ranks on one GPU; gloo moves CUDA
             tensors through the host): moonshot-v1-16b-a3b's MoE at full
             width (2 blocks' MoE layers, B=1, S=4096, bf16) expert
             parallel over model = 4 against the local path layer by layer
             (bf16 bar, rtol of the largest |value|; tokens whose experts
             differ: must be 0), and GPipe of 4 stages of 2 Qwen1.5-4B
             blocks (f32, B=4, S=512, 4 microbatches): output and each
             stage's gradients against the 8 blocks in order; (c) in
             processes alongside (CPU, meta tensors): the dry-run of
             qwen1.5-4b x train_4k on 256 and 512 fake ranks and the GPipe
             dry-run of gemma2-2b, each printing its three terms,
             bottleneck, collective bytes by kind and seconds.

The kernel phase also holds K3 (mLSTM scan, csrc/mlstm_scan_sm90.cu: a
scalar pass, the state entering each chunk, the outputs; 3xTF32 tensor-core
products) against its plain version: the tests/test_kernels.py sweep in f32
(also against another chunk) and bf16, the kernel bench's widths, strided
views in f32 and bf16, the gate extremes of the CPU tests (m at its floor of
-40; a stabilizer that switches between chunks), dh=512 at chunk 256, dh=6,
bases off 16-byte alignment and chunk 1. It times the xLSTM-125m layer shape (B=8, H=4, S=2048, dh=384) at
chunk 256 and 128 (one eager call, the device time from CUDA-graph replays,
and each pass alone), the kernel bench's two shapes and K3_WIDE_SHAPES, and
the scalar pass alone at chunk 512 and 1024; with
``--baseline-src DIR`` (a directory holding the earlier CUDA-core kernels,
K3's csrc/mlstm_scan.cu, K2's f32 csrc/flash_attention.cu and K1's
csrc/paged_attention.cu, unpacked from older commits;
benchmarks_torch/baselines.py) it times each beside the kernel that
replaced it on the same inputs. The small phase also runs a reduced
5-layer xLSTM on the card against the CPU.

It prints the whole run's wall time, a JSON ``kernels`` line, the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``. TF32 is off throughout.
"""
import argparse
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

from benchmarks_torch import kernel_bench
from benchmarks_torch.kernel_bench import device_ms as _device_ms
from benchmarks_torch.kernel_bench import time_ms as _time_ms
from repro_torch import tree as tree_lib
from repro_torch.configs.base import RunConfig, ShapeConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.core import faults as sim_faults
from repro_torch.core import metrics as sim_met
from repro_torch.core import simulator as sim
from repro_torch.core import telemetry as sim_tel
from repro_torch.core import validate as sim_val
from repro_torch.core import workloads as sim_wl
from repro_torch.core.params import SimConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import hymba, lm, whisper, xlstm
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import rms_norm, softmax_xent
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.roofline.analysis import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                           TF32_FLOPS_PER_S, bound_ms)
from repro_torch.serving import paged_lm
from repro_torch.serving.engine import generate_requests
from repro_torch.serving.types import default_clients
from repro_torch.train import steps as train_steps
from repro_torch.train.trainer import Trainer

F32_TOL = dict(atol=2e-5, rtol=2e-4)     # tests/test_kernels.py
BF16_TOL = dict(atol=2e-3, rtol=2e-2)
F16_TOL = dict(atol=1e-3, rtol=2e-3)     # float16: 11 significant bits
TOLS = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL,
        torch.float16: F16_TOL}

SERVE_LAYERS_PER_STEP = 40       # Qwen1.5-4B depth
SERVE_PAGE, SERVE_PAGES, SERVE_SLOTS = 16, 2048, 32
SERVE_HORIZON_MS = 2000.0
SERVE_STEP_CAP = 1600            # the first interactive finish is near 1256
SERVE_CHECK_STEP = 300           # recomputed with the plain attention

FWD_B, FWD_S = 2, 4096           # S: the RunConfig.seq_len default
FWD_TIMED = 3                    # timed forwards, after one warm-up
FLASH_SWEEP = [                  # tests/test_kernels.py:21-28
    # B, Hq, Hkv, Sq, Sk, d, causal, window, softcap
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),      # GQA
    (1, 8, 4, 256, 256, 32, True, 64, 0.0),     # sliding window
    (1, 2, 2, 128, 256, 64, False, 0, 50.0),    # softcap, cross length
    (2, 6, 1, 64, 128, 128, True, 0, 0.0),      # MQA
    (1, 4, 4, 192, 192, 16, True, 128, 30.0),   # window + softcap
]
MLSTM_SWEEP = [                  # tests/test_kernels.py:97-100
    # B, H, S, dh, chunk
    (2, 2, 64, 16, 16),
    (1, 4, 128, 32, 32),
    (1, 1, 96, 8, 96),           # single chunk
    (2, 1, 64, 16, 8),           # many small chunks
]
K3_WIDE_SHAPES = [               # K3 past one block's dh: B, H, S, dh, chunk
    # dh = ssm_expand 2 x d_model / 4 heads (models/xlstm.py:30-35, the
    # rule of configs/xlstm_125m.py) at the d_model of arXiv:2405.04517's
    # 760M, 1.3B and 2.7B models (1536, 2048, 2560); then xlstm-125m's
    # dh=384 at chunk 512, and the narrowest CTA (dh=64, the 64-column
    # instance) at chunk 512
    (8, 4, 2048, 768, 256), (8, 4, 2048, 1024, 256),
    (8, 4, 2048, 1280, 256), (8, 4, 2048, 384, 512),
    (8, 4, 2048, 64, 512),
]
K3_BASELINE = "774e907"          # K3 before its cluster pass (the same
                                 # file as 076818b's)
XLSTM_B, XLSTM_S = 8, 2048       # 16,384 scored tokens per call
XLSTM_TIMED = 3                  # timed forwards, after one warm-up
XLSTM_DECODE = 8                 # greedy decode steps after the prefill
XLSTM_CHUNK = 256                # models/xlstm.mlstm_chunk_scan's chunk
PAGED_GROUP_SHAPES = {           # K1 at published widths: (Hq, Hkv, d)
    "qwen3-235b-a22b 64/4 d128": (64, 4, 128),     # g = 16
    "mistral-large-2 96/8 d128": (96, 8, 128),     # g = 12
    "starcoder MQA 48/1 d128": (48, 1, 128),       # g = 48
    "falcon-7b MQA 71/1 d64": (71, 1, 64),         # g = 71
    "qwen1.5-110b 64/8 d128": (64, 8, 128),        # g = 8: the paged serve
                                                   # path's largest group
    "d512 g2 16/8": (16, 8, 512),
}


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_heterogeneous_torch",
        os.path.join(ROOT, "examples", "serve_heterogeneous_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(name, got, want, tol, *, rtol_of_max=False):
    """Elementwise ``|got - want| <= atol + rtol * |want|``; with
    ``rtol_of_max`` the rtol term is taken of ``max |want|`` instead."""
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    bound = tol["atol"] + tol["rtol"] * (ref.max() if rtol_of_max else ref)
    worst = float(err.max()) if err.numel() else 0.0
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"max |err| {worst:.3e}")
    return worst


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _zero_counts():
    """Every kernel's launch count to 0, before a main path is driven."""
    for fn in (ops.paged_attention, fa_ops.flash_attention, ml_ops.mlstm_scan):
        fn.launches = 0
    fa_ops.flash_attention.launches_bf16 = 0
    fa_ops.flash_attention.launches_f16 = 0
    ops.paged_attention.launches_mma = 0


def _against_previous(name, fn, previous, tol, commit=None, want=None,
                      **kw):
    """A kernel beside an earlier build's (``previous``, the source of
    ``commit``: benchmarks_torch/baselines.py) on the same inputs: the two
    outputs at ``tol``, then device ms per call in two rounds of turns,
    previous, this, this, previous (CUDA-graph replays). Where the caller
    gives the plain version's output (``want``; it holds this build to it
    itself) the earlier build's error against it is recorded and, past
    ``tol``, printed, not raised: the earlier build is only timed here, and
    two kernels each within ``tol`` of the plain version may be twice that
    apart. None without a baseline."""
    if previous is None:
        return None
    commit = commit or SM90_BASELINE
    rec = {"source_commit": commit}
    if want is None:
        rec["max_abs_err_vs_previous"] = _assert_close(
            f"{name}: this build vs commit {commit}'s", fn(), previous(), tol,
            **kw)
    else:
        try:
            rec["previous_max_abs_err_vs_plain"] = _assert_close(
                f"{name}: commit {commit}'s", previous(), want, tol, **kw)
            rec["previous_within_tol"] = True
        except AssertionError as e:
            rec["previous_within_tol"] = False
            print(f"[kernels] note: {e} (commit {commit}'s build, timed only)")
    mine, prev = _in_turns(fn, previous)
    rec.update(device_ms=mine, previous_device_ms=prev,
               ratio=sum(mine) / sum(prev))
    print(f"[kernels] {name}: device ms this build "
          f"{' / '.join(f'{x:.4f}' for x in mine)}, commit {commit}'s "
          f"{' / '.join(f'{x:.4f}' for x in prev)} (two rounds of previous, "
          f"this, this, previous; ratio {rec['ratio']:.4f})")
    return rec


def _in_turns(fn, other):
    """Device ms per call of ``fn`` and ``other`` in two rounds of turns,
    other, fn, fn, other (CUDA-graph replays): ([fn] x 4, [other] x 4)."""
    t = [_device_ms(f, 10, 5) for _ in range(2)
         for f in (other, fn, fn, other)]
    return t[1::4] + t[2::4], t[0::4] + t[3::4]


# the sm90 sources' yardstick (benchmarks_torch/baselines.py): commit
# 076818b's, before the cluster routes of K2's float32 route past d = 256
# and K1's wide route
SM90_BASELINE = "076818b"
K1_BASELINE = SM90_BASELINE


def _paged_inputs(gen, B, Hq, Hkv, d, page, n_slots, P, lengths, dtype):
    dev = "cuda"
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(P, Hkv, page, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(P, Hkv, page, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)
    pt = perm[: B * n_slots].reshape(B, n_slots).to(torch.int32)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, pt.contiguous(), ln


def phase_build():
    t0 = time.perf_counter()
    took = _build.build()
    print(f"[build] {json.dumps({n: round(s, 2) for n, s in took.items()})} "
          f"total {time.perf_counter() - t0:.2f} s")
    for name in took:
        log = _build.build_log(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        smem = [int(w) for w in re.findall(r"(\d+) bytes smem", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {name}: {len(regs)} kernels, registers <= "
              f"{max(regs, default=0)}, smem <= {max(smem, default=0)} B, "
              f"spill bytes {spills}")


def _paged_case(errs, name, x, tol, *, softcap=0.0, splits=(None,)):
    """K1 on x against its plain version at each pages_per_split (None:
    the public wrapper at ``_pages_per_split``'s choice, which must move
    ``launches`` by one)."""
    want = paged_attention_ref(*x, softcap=softcap)
    for pps in splits:
        if pps is None:
            before = ops.paged_attention.launches
            got = ops.paged_attention(*x, softcap=softcap)
            if ops.paged_attention.launches != before + 1:
                raise AssertionError(f"paged_attention {name}: the wrapper "
                                     f"did not launch the kernel once")
        else:
            got = ops._run_sm90(*x, softcap, pps)
        errs[f"{name} pps={pps or 'auto'}"] = _assert_close(
            f"paged_attention {name} pps={pps}", got, want, tol)


def _paged_bad_ids(errs, name, x, tol, seq, ids, *, softcap=0.0,
                   splits=(None, 1, 2)):
    """x with page ids set as ``ids`` ({(b, slot): id}), one of them outside
    [0, P) inside sequence ``seq``'s length: that sequence's output must be
    NaN at each split and the other sequences' must agree with the plain
    version on x (ids past a length are never read)."""
    want = paged_attention_ref(*x, softcap=softcap)
    x = list(x)
    x[3] = x[3].clone()
    for (b, slot), pid in ids.items():
        x[3][b, slot] = pid
    rest = [b for b in range(x[0].shape[0]) if b != seq]
    for pps in splits:
        got = (ops.paged_attention(*x, softcap=softcap) if pps is None
               else ops._run_sm90(*x, softcap, pps))
        if not bool(torch.isnan(got[seq]).all()):
            raise AssertionError(f"paged_attention {name} pps={pps}: a bad "
                                 f"id inside the length must give NaN")
        errs[f"{name}, the other sequences, pps={pps or 'auto'}"] = \
            _assert_close(f"paged_attention {name} pps={pps}", got[rest],
                          want[rest], tol)


def _paged_work(x):
    """K1's work on x: the bytes it must move (the live K and V rows, q in,
    out, the lengths and the live page ids), its flops (q.k and p.v over the
    live keys) and the live keys."""
    q, kp, _, pt, ln = x
    B, Hq, d = q.shape
    page, elt = kp.shape[2], q.element_size()
    lens = torch.clamp(ln.long(), 0, pt.shape[1] * page)
    keys = int(lens.sum())
    pages = int(((lens + page - 1) // page).sum())
    n_bytes = (2 * keys * kp.shape[1] * d * elt + 2 * q.numel() * elt
               + 4 * (B + pages))
    return n_bytes, 4 * keys * Hq * d, keys


def _paged_times(x, enable_gqa=True, previous=None):
    """K1 timed two ways: ``ms`` keys are one call between two CUDA events
    (median of 50), the wrapper's host work included, the kernels line's
    measure; ``device_ms`` keys are device time per call from CUDA-graph
    replays of 20 calls. For the public wrapper (``_pages_per_split``'s
    choice), the kernel at one split (device only), SDPA over pre-gathered
    pages and, where given, an earlier kernel behind the same input checks
    as the wrapper; beside the bound, its flops at the card's peak rate for
    the inputs' dtype and route (float32 on the CUDA cores, or on the mma
    route as three TF32 products each, with the f32-rate figure beside it;
    bfloat16 and float16 on the tensor cores)."""
    B, Hq, _ = x[0].shape
    Hkv, n_slots = x[1].shape[1], x[3].shape[1]
    n_bytes, n_flops, _ = _paged_work(x)
    wrapper = lambda: ops.paged_attention(*x)
    lib = kernel_bench.paged_sdpa(x, enable_gqa)
    plan = ops.sm90_plan(Hq // Hkv, x[0].shape[2], x[1].shape[2], x[0].dtype)
    t = {"pages_per_split": ops._pages_per_split(
        B, Hkv * plan["tiles"], n_slots, ops._sm_count(0)), **plan,
        "ms": _time_ms(wrapper, 50), "device_ms": _device_ms(wrapper),
        "device_ms_one_split": _device_ms(
            lambda: ops._run_sm90(*x, 0.0, n_slots)),
        "library_ms": _time_ms(lib, 50), "library_device_ms": _device_ms(lib)}
    if previous is not None:
        prev = lambda: (ops._check(*x), previous(*x))
        t["previous_ms"] = _time_ms(prev, 50)
        t["previous_device_ms"] = _device_ms(prev)
    rate = (F32_FLOPS_PER_S if x[0].dtype == torch.float32
            else BF16_FLOPS_PER_S)
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops, rate)
    if plan["route"] == "mma" and x[0].dtype == torch.float32:
        t["bound_f32_rate_ms"] = t["bound_ms"]
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, 3 * n_flops,
                                                TF32_FLOPS_PER_S)
    t["bound_bytes_ms"] = bound_ms(n_bytes, 0, rate)[0]
    for k in ("ms", "device_ms"):
        t[f"gb_s_{k}"] = n_bytes / t[k] / 1e6
        t[f"bound_share_{k}"] = t["bound_ms"] / t[k]
    return t


def _paged_formerly_refused(errs, gen):
    """Shapes that K1 once refused (g > 8, d > 256) or sent to an earlier
    CUDA-core kernel (rows not a multiple of 16 bytes, pages over 256 keys
    or 32 KiB, pools off 16-byte alignment), through the public wrapper and
    at set splits: each wrapper call must move ``launches`` by one, and
    every result agree with the plain version. Two of the pools the
    producer warp's own loads stage get a bad page id inside a length."""
    def off(x, elts):                  # both pools `elts` elements past
        x = list(x)                    # an aligned address
        for i in (1, 2):
            flat = torch.empty(x[i].numel() + elts, dtype=x[i].dtype,
                               device="cuda")
            x[i] = flat[elts:].view(x[i].shape).copy_(x[i])
        return x
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("f32 d=6, 24-byte rows", _paged_inputs(
            gen, 3, 4, 2, 6, 16, 4, 16, [0, 37, 64], f32), F32_TOL),
        ("bf16 d=12, 24-byte rows, g=9", _paged_inputs(
            gen, 3, 9, 1, 12, 16, 4, 16, [5, 37, 64], bf16), BF16_TOL),
        ("f32 d=256 page 64, 64 KiB pages", _paged_inputs(
            gen, 2, 4, 2, 256, 64, 3, 8, [100, 192], f32), F32_TOL),
        ("f32 page 512 keys, g=4", _paged_inputs(
            gen, 3, 8, 2, 128, 512, 3, 16, [1, 700, 1536], f32), F32_TOL),
        ("f32 pools 4 bytes off 16-byte alignment", off(_paged_inputs(
            gen, 3, 4, 2, 32, 16, 4, 16, [20, 64, 41], f32), 1), F32_TOL),
        ("bf16 pools 2 bytes off, d=7 page 300", off(_paged_inputs(
            gen, 2, 12, 4, 7, 300, 2, 6, [301, 599], bf16), 1), BF16_TOL),
        ("f32 g=9 (18/2)", _paged_inputs(
            gen, 3, 18, 2, 128, 16, 5, 32, [0, 33, 80], f32), F32_TOL),
        ("bf16 MQA g=16", _paged_inputs(
            gen, 3, 16, 1, 128, 16, 5, 32, [17, 64, 80], bf16), BF16_TOL),
        ("f32 d=512 g=2", _paged_inputs(
            gen, 2, 4, 2, 512, 16, 4, 16, [0, 57], f32), F32_TOL),
        ("bf16 d=2048 g=9 (9/1)", _paged_inputs(
            gen, 2, 9, 1, 2048, 16, 3, 8, [40, 48], bf16), BF16_TOL),
    ]
    for name, x, tol in cases:
        _paged_case(errs, f"(i) {name}", x, tol, softcap=30.0,
                    splits=(None, 1, 2))
    # bad ids: slot 1 starts at 16 < 37 and at 300 < 301
    _paged_bad_ids(errs, "(i) bad id, " + cases[0][0], cases[0][1],
                   F32_TOL, 1, {(1, 1): 16 + 3}, softcap=30.0)
    _paged_bad_ids(errs, "(i) bad id, " + cases[5][0], cases[5][1],
                   BF16_TOL, 0, {(0, 1): -2}, softcap=30.0)


def _paged_group_shapes(errs, gen, previous=None):
    """K1 at published attention widths with eight or more query heads per
    kv head and at d = 512 (``PAGED_GROUP_SHAPES``), B=32, page 16, 36
    slots, random lengths, f32, bf16 and f16. First the mma route's main
    path: the public wrapper once per shape and type, every count at 0
    before and read after (each output finite); the route of each plan
    printed, "mma" wherever g > 8 and the wrapper's rule the source's.
    Then each held against the plain version at the wrapper's splits and
    at one split, timed beside the bound and SDPA (``enable_gqa``); at g =
    8 the route not taken too, held and timed in turns with the taken one;
    with ``previous`` (commit 076818b's K1) that kernel in turns. Returns
    the rows and the main path's launches."""
    cases = {}
    for name, (Hq, Hkv, d) in PAGED_GROUP_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            B, page, n_slots = 32, 16, 36
            lens = torch.randint(1, page * n_slots + 1, (B,), generator=gen,
                                 device="cuda")
            key = f"{name} {str(dtype)[6:].replace('float', 'f')}"
            cases[key] = _paged_inputs(gen, B, Hq, Hkv, d, page, n_slots,
                                       SERVE_PAGES, lens, dtype)
    _zero_counts()
    for key, x in cases.items():
        out = ops.paged_attention(*x)
        if out.shape != x[0].shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged_attention (j) {key}: output not "
                                 f"finite or of q's shape")
    launches = {"all": ops.paged_attention.launches,
                "mma": ops.paged_attention.launches_mma}
    if not launches["mma"]:
        raise AssertionError("(j): the mma route never launched")
    print(f"[kernels] paged_attention (j) main path of the mma route: "
          f"launches {json.dumps(launches)}")
    rows = {}
    for key, x in cases.items():
        B, Hq, d = x[0].shape
        Hkv, g, elt = x[1].shape[1], Hq // x[1].shape[1], x[0].element_size()
        tol = TOLS[x[0].dtype]
        _paged_case(errs, f"(j) {key}", x, tol, splits=(None, 1))
        t = _paged_times(x)
        if t["source_mma_route"] != ops.mma_route(g, d, elt):
            raise AssertionError(f"(j) {key}: ops.mma_route and the source's "
                                 f"rule differ")
        if (t["route"] == "mma") != ops.mma_route(g, d, elt) or (
                g > 8 and t["route"] != "mma"):
            raise AssertionError(f"(j) {key}: g = {g} took the {t['route']} "
                                 f"route")
        t["plain_ms"] = _time_ms(lambda: paged_attention_ref(*x), 5)
        wrapper = lambda: ops.paged_attention(*x)       # noqa: E731
        if g == 8:                     # both routes, in turns
            other = (ops.tile_rows(g, d, elt) if t["route"] == "mma"
                     else ops.mma_tile_rows(g))
            plan = ops.sm90_plan(g, d, x[1].shape[2], x[0].dtype, rows=other)
            errs[f"(j) {key} on the {plan['route']} route"] = _assert_close(
                f"paged_attention (j) {key} {plan['route']} route",
                ops._run_sm90(*x, 0.0, rows=other), paged_attention_ref(*x),
                tol)
            mine, theirs = _in_turns(
                wrapper, lambda: ops._run_sm90(*x, 0.0, rows=other))
            t["other_route"] = {"route": plan["route"], "device_ms": theirs,
                                "this_route_device_ms": mine,
                                "ratio": sum(mine) / sum(theirs)}
            print(f"[kernels] paged_attention (j) {key}: in turns, the "
                  f"{t['route']} route {' / '.join(f'{v:.4f}' for v in mine)}"
                  f" ms device, the {plan['route']} route "
                  f"{' / '.join(f'{v:.4f}' for v in theirs)} (ratio "
                  f"{t['other_route']['ratio']:.4f})")
        t["previous"] = _against_previous(
            f"paged_attention (j) {key}", wrapper,
            None if previous is None else (lambda: previous(*x)), tol,
            commit=K1_BASELINE)
        rows[key] = t
        f32_s = (f", {t['bound_f32_rate_ms']:.4f} at the f32 rate"
                 if "bound_f32_rate_ms" in t else "")
        print(f"[kernels] paged_attention (j) {key}: B={B} Hq={Hq} Hkv={Hkv}"
              f" d={d} page=16 slots=36, the {t['route']} route, "
              f"{t['tiles']} tiles of {t['tile_rows']} rows, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; bytes alone "
              f"{t['bound_bytes_ms']:.4f}{f32_s}); one eager call "
              f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms at "
              f"{t['pages_per_split']} pages per split "
              f"({t['bound_share_device_ms']:.3f} of the bound), "
              f"{t['device_ms_one_split']:.4f} at one split; sdpa "
              f"{t['library_ms']:.4f} eager, {t['library_device_ms']:.4f} "
              f"device; plain {t['plain_ms']:.4f}")
    del cases
    torch.cuda.empty_cache()
    return rows, launches


def phase_kernels(baseline):
    """K1 against its plain version, timed; returns the serving-shape
    record. ``baseline`` (benchmarks_torch/baselines.py, maybe empty): the
    earlier CUDA-core kernel, timed beside K1 at the serving shape, and
    commit 076818b's K1 (before the wide route's clusters), timed in turns
    at the serving shape, the kernel bench's shapes, ``PAGED_GROUP_SHAPES``
    and the wide route's shapes."""
    previous = baseline.get("paged_attention")
    old = baseline.get("paged_attention_sm90")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    B, H, d, page, n_slots, P = 32, 20, 128, 16, 36, SERVE_PAGES
    lens = torch.randint(1, page * n_slots + 1, (B,), generator=gen,
                         device="cuda")
    x = _paged_inputs(gen, B, H, H, d, page, n_slots, P, lens, torch.float32)
    _paged_case(errs, "(a) serving shape f32", x, F32_TOL,
                splits=(None, 1, 4, 9))
    err_a = errs["(a) serving shape f32 pps=auto"]
    lens_b = torch.randint(1, 16 * 8 + 1, (6,), generator=gen, device="cuda")
    xb = _paged_inputs(gen, 6, 8, 4, 256, 16, 8, 64, lens_b, torch.bfloat16)
    _paged_case(errs, "(b) GQA d=256 softcap bf16", xb, BF16_TOL,
                softcap=50.0, splits=(None, 1, 3))
    # lengths 0, 1, an exact page multiple, ragged; ids -1 past the length
    xc = list(_paged_inputs(gen, 5, 6, 2, 80, 16, 4, 32,
                            [0, 1, 16, 48, 37], torch.float32))
    starts = torch.arange(4, device="cuda") * 16
    xc[3] = torch.where(starts[None, :] < xc[4][:, None], xc[3],
                        torch.full_like(xc[3], -1)).contiguous()
    for pps in (None, 1, 2, 3):
        got = (ops.paged_attention(*xc) if pps is None
               else ops._run_sm90(*xc, 0.0, pps))
        if bool(got[0].abs().max() != 0):
            raise AssertionError(f"paged_attention (c) pps={pps}: length 0 "
                                 f"must give 0")
    _paged_case(errs, "(c) edge lengths, g=3, d=80", xc, F32_TOL,
                splits=(None, 1, 2, 3))
    xd = _paged_inputs(gen, 4, 4, 2, 16, 8, 3, 16, [5, 8, 24, 13],
                       torch.float32)
    _paged_case(errs, "(d) d=16 (example width)", xd, F32_TOL,
                splits=(None, 1, 2))
    # runs of 2 pages (32 keys): lengths on split boundaries, and splits 3-5
    # of every sequence empty
    xe = _paged_inputs(gen, 4, 8, 2, 128, 16, 12, 64, [32, 64, 96, 17],
                       torch.float32)
    _paged_case(errs, "(e) split boundaries, empty trailing splits",
                xe, F32_TOL, splits=(2, 3, 4, 12))
    xf = _paged_inputs(gen, 3, 16, 4, 128, 16, 6, 64, [0, 48, 77],
                       torch.bfloat16)
    _paged_case(errs, "(f) GQA g=4 softcap bf16, length 0", xf,
                BF16_TOL, softcap=30.0, splits=(None, 1, 2, 3))
    # float16: the serving shape's inputs, and Qwen3-235B-A22B's group (64
    # q heads on 4 kv heads) with lengths 0 and 1 among them
    x16 = [t.half() if t.is_floating_point() else t for t in x]
    _paged_case(errs, "(j) serving shape f16", x16, F16_TOL,
                splits=(None, 1, 4))
    lens_j = torch.randint(1, 16 * 36 + 1, (32,), generator=gen,
                           device="cuda")
    lens_j[:2] = torch.tensor([0, 1])
    _paged_case(errs, "(j) Qwen3-235B-A22B 64/4 d=128 f16",
                _paged_inputs(gen, 32, 64, 4, 128, 16, 36, SERVE_PAGES,
                              lens_j, torch.float16), F16_TOL, softcap=30.0,
                splits=(None, 1))
    bench = {}
    for shape in kernel_bench.PAGED_SHAPES:
        xk, _, _ = kernel_bench.paged_inputs("cuda", *shape)
        name = "B{}H{}/{}d{}p{}".format(*shape[:5])
        _paged_case(errs, f"(g) kernel bench {name}", xk, F32_TOL,
                    splits=(None, 1, shape[5]))
        bench[name] = _paged_times(xk)
        bench[name]["previous"] = _against_previous(
            f"paged_attention kernel bench {name}",
            lambda: ops.paged_attention(*xk),
            None if old is None else (lambda: old(*xk)), F32_TOL,
            commit=K1_BASELINE)
    # a page id outside [0, P) inside sequence 1's length: NaN there only;
    # an id of -3 past sequence 2's length is never read; g=16 (MQA, the
    # mma route) and g=2 (the register route), f32 and bf16
    for Hq, Hkv, dtype, tol in ((4, 2, torch.float32, F32_TOL),
                                (16, 1, torch.bfloat16, BF16_TOL)):
        xh = _paged_inputs(gen, 3, Hq, Hkv, 64, 16, 6, 32, [90, 70, 40],
                           dtype)
        _paged_bad_ids(errs, f"(h) bad id, g={Hq // Hkv}", xh, tol, 1,
                       {(1, 2): 32 + 7, (2, 4): -3}, splits=(None, 1, 2, 6))
    _paged_formerly_refused(errs, gen)
    groups, group_launches = _paged_group_shapes(errs, gen, old)
    past = _paged_past_limits(errs, gen, old)
    print("[kernels] paged_attention max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))

    # timing at the serving shape, in f32 (beside commit 076818b's K1)
    # and in f16
    t = _paged_times(x, enable_gqa=False, previous=previous)
    prev_sm90 = _against_previous(
        "paged_attention serving shape f32", lambda: ops.paged_attention(*x),
        None if old is None else (lambda: old(*x)), F32_TOL,
        commit=K1_BASELINE)
    t16 = _paged_times(x16, enable_gqa=False)
    rec16 = {k: t16[k] for k in ("ms", "device_ms", "library_ms",
                                 "library_device_ms", "bound_ms", "bound_by",
                                 "pages_per_split")}
    rec16["max_abs_err"] = errs["(j) serving shape f16 pps=auto"]
    rec16["plain_ms"] = _time_ms(lambda: paged_attention_ref(*x16), 10)
    print(f"[kernels] paged_attention serving shape f16: "
          f"{t16['ms']:.4f} ms eager, {t16['device_ms']:.4f} ms device "
          f"({t16['bound_share_device_ms']:.3f} of the {t16['bound_ms']:.4f} "
          f"ms bound, {t16['bound_by']}), sdpa {t16['library_device_ms']:.4f} "
          f"ms device, plain {rec16['plain_ms']:.4f} ms")
    _, _, keys = _paged_work(x)
    plain_ms = _time_ms(lambda: paged_attention_ref(*x), 10)
    _assert_close("sdpa yardstick",
                  kernel_bench.paged_sdpa(x, False)()[:, :, 0],
                  paged_attention_ref(*x), dict(atol=1e-4, rtol=1e-3))
    log = _build.build_log("paged_attention_sm90")
    regs = max(int(w) for w in re.findall(r"Used (\d+) registers", log))
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
    rec = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention_sm90.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:67",
           "launches": None, "max_abs_err": err_a, "ms": t["ms"],
           "plain_ms": plain_ms, "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": t["library_ms"],
           "timing": "ms, library_ms: one call between two CUDA events, "
                     "host work included; *device_ms: device "
                     "time per call, CUDA-graph replays of 20 calls",
           "device_ms": t["device_ms"],
           "library_device_ms": t["library_device_ms"],
           "device_ms_one_split": t["device_ms_one_split"],
           "pages_per_split": t["pages_per_split"],
           "stages": t["stages"], "smem_bytes": t["smem_bytes"],
           "kernel_bench_shapes": bench, "group_shapes": groups,
           "previous_sm90": prev_sm90, "f16": rec16, "past_limit_shapes": past,
           "routes": _k1_routes(groups, group_launches)}
    prev_s = ""
    if previous is not None:
        rec["previous"] = {"source": "src/repro_torch/csrc/"
                                     "paged_attention.cu (commit 8d1f884)",
                           "ms": t["previous_ms"],
                           "device_ms": t["previous_device_ms"]}
        prev_s = (f"; the earlier CUDA-core kernel {t['previous_ms']:.4f} "
                  f"ms eager, "
                  f"{t['previous_device_ms']:.4f} ms device")
    print(f"[kernels] paged_attention serving shape B={B} H={H} d={d} "
          f"page={page} slots={n_slots} keys={keys}, bound "
          f"{t['bound_ms']:.4f} ms; one eager call (host work included): "
          f"{t['ms']:.4f} ms ({t['gb_s_ms']:.1f} GB/s, "
          f"{t['bound_share_ms']:.3f} of the bound), sdpa "
          f"{t['library_ms']:.4f} ms, plain {plain_ms:.4f} ms; device ms "
          f"per call (graph replays): {t['device_ms']:.4f} ms at "
          f"{t['pages_per_split']} pages per split "
          f"({t['gb_s_device_ms']:.1f} GB/s, "
          f"{t['bound_share_device_ms']:.3f} of the bound), "
          f"{t['device_ms_one_split']:.4f} ms at one split, sdpa "
          f"{t['library_device_ms']:.4f} ms{prev_s}; kernel: "
          f"{t['stages']} stages, {t['smem_bytes']} B dynamic shared "
          f"memory, registers <= {regs} (all instances), spill bytes "
          f"{spills}")
    if t["bound_share_ms"] < 0.5:
        print(f"[kernels] note: one eager call of K1 reaches "
              f"{t['bound_share_ms']:.3f} of the bound at the serving shape, "
              f"under half")
    for name, b in bench.items():
        print(f"[kernels] paged_attention kernel bench {name}, bound "
              f"{b['bound_ms']:.4f} ms; one eager call {b['ms']:.4f} ms, "
              f"sdpa {b['library_ms']:.4f} ms; device ms per call: "
              f"{b['device_ms']:.4f} ms at {b['pages_per_split']} pages per "
              f"split ({b['gb_s_device_ms']:.1f} GB/s, "
              f"{b['bound_share_device_ms']:.3f} of the bound), "
              f"{b['device_ms_one_split']:.4f} ms at one split, sdpa "
              f"{b['library_device_ms']:.4f} ms")
        for k in ("ms", "device_ms"):
            if not b[k] < b[f"library_{k}"]:
                print(f"[kernels] note: at {name} K1 is not faster than SDPA "
                      f"by {k}")
    return rec


def _k1_routes(groups, launches):
    """The K1 record's routes: the register route's launches (the serve
    path's, added in main) and the mma route's, on its main path (the
    public wrapper at ``PAGED_GROUP_SHAPES``, phase (j)), with its numbers
    at Qwen3-235B-A22B's bf16 group and every group shape's route, device
    ms and bound."""
    head = groups["qwen3-235b-a22b 64/4 d128 bf16"]
    return {
        "registers": {"launches": launches["all"] - launches["mma"],
                      "main_path": "the serve phase (Qwen1.5-4B, g = 1)"},
        "mma": {"launches": launches["mma"],
                "main_path": "ops.paged_attention at PAGED_GROUP_SHAPES, "
                             "phase (j)",
                "shape": "qwen3-235b-a22b 64/4 d128 bf16, B=32",
                **{k: head[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms")},
                "shapes": {k: {f: v.get(f) for f in (
                    "route", "device_ms", "bound_ms", "bound_by",
                    "bound_f32_rate_ms", "library_device_ms")}
                    for k, v in groups.items()}}}


# ---- shapes past the card's old limits --------------------------------------

def _past_limit_time(name, fn, plain, lib, n_bytes, n_flops, rate, err, why=None,
                     agree=None):
    """One past-limit shape's times: one eager call between two CUDA events
    (``ms``), device ms per call (CUDA-graph replays), the plain version's
    ms (None where ``plain`` is None), the bound and, where SDPA computes
    the same function (``lib``), its device ms; else ``library`` says
    why not (``why``, or SDPA's own refusal). ``agree``, where given, is
    handed SDPA's first output and raises if it is not the same function."""
    t = {"max_abs_err": err, "ms": _time_ms(fn, 5),
         "device_ms": _device_ms(fn, 3, 3),
         "plain_ms": None if plain is None else _time_ms(plain, 2)}
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flops, rate)
    t["library_ms"] = t["library_device_ms"] = None
    t["library"] = why
    if lib is not None:
        try:
            out = lib()
            torch.cuda.synchronize()
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            t["library"] = f"sdpa refused: {str(e).splitlines()[0][:160]}"
            torch.cuda.empty_cache()
        else:
            if agree is not None:
                agree(out)
            del out
            t["library"] = "sdpa"
            t["library_ms"] = _time_ms(lib, 3)
            t["library_device_ms"] = _device_ms(lib, 3, 3)
    lib_s = (f"sdpa {t['library_ms']:.4f} ms eager, "
             f"{t['library_device_ms']:.4f} ms device"
             if t["library_ms"] is not None else f"no sdpa ({t['library']})")
    plain_s = ("not measured" if t["plain_ms"] is None
               else f"{t['plain_ms']:.4f} ms")
    print(f"[kernels] past the old limits: {name}: {t['ms']:.4f} ms eager, "
          f"{t['device_ms']:.4f} ms device, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}; {t['bound_ms'] / t['device_ms']:.3f} of it); "
          f"{lib_s}; plain {plain_s}; max|err| {err:.3e}")
    return t


def _paged_past_limits(errs, gen, previous=None):
    """K1 past its old limits, through the public wrapper (each call must
    move ``launches`` by one) and at set splits, against the plain version:
    the wide route (d = 2056, 4096, 16,384 and, past one cluster's reach,
    18,432; g = 1 and 8; softcap on in one case, the split route taken in
    one; pools 2 bytes off alignment for the 2-byte loads; a bad page id),
    65,543 sequences and 65,539 kv heads; each timed
    beside its bound and SDPA over pre-gathered pages (where no softcap);
    the wide route's shapes, with ``previous`` (commit 076818b's K1), in
    turns with it."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16

    def off(x):                        # both pools 2 bytes off alignment
        x = list(x)
        for i in (1, 2):
            flat = torch.empty(x[i].numel() + 1, dtype=x[i].dtype,
                               device="cuda")
            x[i] = flat[1:].view(x[i].shape).copy_(x[i])
        return x

    def lens(B, n):
        return torch.randint(1, n + 1, (B,), generator=gen, device="cuda")
    cases = [  # name, inputs, tol, softcap, splits
        ("d=2056 g=1 f32", _paged_inputs(
            gen, 4, 4, 4, 2056, 16, 8, 64, lens(4, 128), f32), F32_TOL, 0.0,
         (None, 1, 2)),
        ("d=2056 g=8 bf16, pools 2 bytes off (2-byte loads)", off(
            _paged_inputs(gen, 2, 8, 1, 2056, 16, 4, 16, lens(2, 64), bf16)),
         BF16_TOL, 0.0, (None, 1)),
        ("d=4096 g=8 bf16 softcap 30", _paged_inputs(
            gen, 3, 16, 2, 4096, 16, 6, 32, lens(3, 96), bf16), BF16_TOL,
         30.0, (None, 1, 3)),
        ("d=4096 g=1 f32", _paged_inputs(
            gen, 2, 2, 2, 4096, 16, 6, 16, lens(2, 96), f32), F32_TOL, 0.0,
         (None, 1)),
        ("d=16384 g=8 f32 (split route)", _paged_inputs(
            gen, 2, 8, 1, 16384, 16, 8, 32, lens(2, 128), f32), F32_TOL, 0.0,
         (None, 1, 2)),
        ("d=16384 g=1 f16", _paged_inputs(
            gen, 2, 2, 2, 16384, 16, 4, 16, lens(2, 64), f16), F16_TOL, 0.0,
         (None, 1)),
        ("d=18432 g=8 f32 (past one cluster: two groups of 8 slices)",
         _paged_inputs(gen, 2, 8, 1, 18432, 16, 4, 16, lens(2, 64), f32),
         F32_TOL, 0.0, (None, 1, 2)),
        ("B=65543 Hq=8 Hkv=1 d=64 page 16 f32", _paged_inputs(
            gen, 65543, 8, 1, 64, 16, 2, 2 * 65543, lens(65543, 32), f32),
         F32_TOL, 0.0, (None, 1)),
        ("Hkv=65539 B=1 d=16 f32", _paged_inputs(
            gen, 1, 65539, 65539, 16, 16, 2, 4, lens(1, 32), f32), F32_TOL,
         0.0, (None, 1)),
    ]
    # a bad page id on the wide route: NaN on its sequence only, in every
    # CTA of its clusters
    _paged_bad_ids(errs, "(p) bad id, d=4100 g=8 f32 (wide route)",
                   _paged_inputs(gen, 3, 8, 1, 4100, 16, 6, 32, [90, 70, 40],
                                 f32), F32_TOL, 1, {(1, 2): 32 + 7,
                                                    (2, 4): -3},
                   splits=(None, 1, 2))
    rows = {}
    for name, x, tol, cap, splits in cases:
        _paged_case(errs, f"(p) {name}", x, tol, softcap=cap, splits=splits)
        B, Hq, d = x[0].shape
        Hkv = x[1].shape[1]
        n_bytes, n_flops, _ = _paged_work(x)
        rate = F32_FLOPS_PER_S if x[0].dtype == f32 else BF16_FLOPS_PER_S
        plan = ops.sm90_plan(Hq // Hkv, d, x[1].shape[2], x[0].dtype)
        pps = ops._pages_per_split(B, Hkv * plan["tiles"] * plan["slices"],
                                   x[3].shape[1], ops._sm_count(0))
        n_split = -(-x[3].shape[1] // pps)
        t = _past_limit_time(
            f"paged_attention {name}", lambda: ops.paged_attention(
                *x, softcap=cap), lambda: paged_attention_ref(
                *x, softcap=cap),
            None if cap else kernel_bench.paged_sdpa(x),
            n_bytes, n_flops, rate, errs[f"(p) {name} pps=auto"],
            why="sdpa has no softcap" if cap else None)
        t.update(route=plan["route"], tile_rows=plan["tile_rows"],
                 slices=plan["slices"], pages_per_split=pps,
                 workspace_bytes=(4 * B * Hq * n_split * (d + 2)
                                  if n_split > 1 else 0))
        if plan["route"] == "wide":
            t.update(ops.wide_clusters(plan["tile_rows"], d, x[0].dtype))
            print(f"[kernels] paged_attention {name}: the wide route, "
                  f"{plan['slices']} slices of {ops.WIDE_COLS} columns, "
                  f"{t['cluster']} CTAs a cluster, at most "
                  f"{t['max_active_clusters']} such clusters active at once "
                  f"(cudaOccupancyMaxActiveClusters)")
            t["previous"] = _against_previous(
                f"paged_attention {name}", lambda: ops.paged_attention(
                    *x, softcap=cap), None if previous is None else (
                    lambda: previous(*x, softcap=cap)), tol,
                commit=K1_BASELINE)
        rows[name] = t
        del x
    torch.cuda.empty_cache()
    return rows


def _flash_past_limits(gen):
    """K2 at 65,537 q tiles (past the grid's old 65,535): bf16 at d = 256
    (q past 2^31 elements, 4.3 GB), f16 at d = 64 and f32 at d = 256 (64-row
    tiles, 4,194,368 rows), Sk = 256, causal and not. Rows do not depend on
    each other, so the plain version runs on slices: the first q tile, the
    last three and one in the middle; under top-left causal alignment a row
    at index >= Sk - 1 sees every key, and there the plain version takes
    causal=False. Timed beside the bound and SDPA's times: SDPA's is_causal
    keeps the same top-left triangle, and its output is held against the
    plain version on the same slices before it is timed. The plain version
    is not timed at these shapes: its float32 scores alone would take 8.6
    GB."""
    rows = {}
    for dtype, d, causal in ((torch.bfloat16, 256, True),
                             (torch.bfloat16, 256, False),
                             (torch.float16, 64, True),
                             (torch.float32, 256, False),
                             (torch.float32, 256, True)):
        tq = fa_ops.q_rows_per_block(dtype, d)
        Sq, Sk = 65537 * tq, 256
        tname = str(dtype)[6:]
        name = (f"{tname} d={d} Sq={Sq} (65,537 tiles of {tq}) Sk={Sk} "
                f"{'causal' if causal else 'non-causal'}")
        x = _flash_inputs(gen, 1, 1, 1, Sq, Sk, d, dtype)
        fn = lambda: fa_ops.flash_attention(*x, causal=causal)  # noqa: E731
        before = fa_ops.flash_attention.launches
        got = fn()
        if fa_ops.flash_attention.launches != before + 1:
            raise AssertionError(f"flash_attention past-limit {name}: the wrapper "
                                 f"did not launch the kernel once")
        err, wants = 0.0, []
        for r0, r1 in ((0, tq), (32768 * tq, 32769 * tq),
                       (65534 * tq, Sq)):
            qs = x[0][:, :, r0:r1]
            c = causal and r0 < Sk - 1
            wants.append((r0, r1, attention_ref(qs, x[1], x[2], causal=c)))
            err = max(err, _assert_close(
                f"flash_attention past-limit {name} rows {r0}-{r1}",
                got[:, :, r0:r1], wants[-1][2], TOLS[dtype]))
        del got

        def agree(out, name=name, wants=wants):
            for r0, r1, want in wants:
                _assert_close(f"sdpa past-limit {name} rows {r0}-{r1}",
                              out[:, :, r0:r1], want, TOLS[dtype])
        elt = x[0].element_size()
        n_bytes = 2 * Sq * d * elt + 2 * Sk * d * elt
        visible = (Sq * Sk - Sk * (Sk - 1) // 2) if causal else Sq * Sk
        n_flops = 4 * visible * d
        rate = TF32_FLOPS_PER_S if dtype == torch.float32 else \
            BF16_FLOPS_PER_S
        sdpa = torch.nn.functional.scaled_dot_product_attention
        t = _past_limit_time(f"flash_attention {name}", fn, None,
                     lambda: sdpa(*x, is_causal=causal), n_bytes,
                     3 * n_flops if dtype == torch.float32 else n_flops,
                     rate, err, agree=agree)
        t["bound_note"] = ("3xTF32 products at the TF32 rate"
                           if dtype == torch.float32 else
                           "the 2-byte tensor-core rate")
        t["q_elements"] = x[0].numel()
        rows[name] = t
        del x, fn, agree, wants
        torch.cuda.empty_cache()
    return rows


def _mlstm_past_limits(rng, previous=None):
    """K3 past its old limits (chunk 256, dh 512): chunk 512 and 1024 at dh
    64 and 384, dh 520, 768 and 1024 at chunk 64 and 256, one past both, and
    dh 4096 and 4100 at chunk 64, two chunks each (so the states pass
    runs), f32 (``_scan_close``: the rtol of max |h| only where the float64
    scan shows the f32 bar below float32's own rounding) and a 2-byte
    type, against the plain version at
    the same chunk; timed beside the bound (f32 CUDA-core rate; the 3xTF32
    bound beside it), and with ``previous`` (commit 774e907's K3) in turns
    with it. K3 has no library counterpart."""
    rows = {}
    cases = [  # B, H, dh, chunk, 2-byte types
        (1, 2, 64, 512, (torch.bfloat16,)), (1, 2, 64, 1024, ()),
        (1, 2, 384, 512, ()), (1, 2, 384, 1024, (torch.float16,)),
        (1, 2, 520, 64, ()), (1, 2, 520, 256, (torch.bfloat16,)),
        (1, 2, 768, 64, ()), (1, 2, 768, 256, ()),
        (1, 2, 1024, 64, ()), (1, 2, 1024, 256, (torch.float16,)),
        (1, 2, 768, 512, ()),
        # past dh 1280 (256 columns a CTA, q.C_prev's slices added in fresh
        # accumulators): where one accumulator over dh drifted past the bar
        (1, 1, 4096, 64, ()), (1, 1, 4100, 64, ()),
    ]
    for B, H, dh, chunk, low in cases:
        S = 2 * chunk
        x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda")
        p = ml_ops.plan(S, dh, chunk)
        for dtype in (torch.float32, *low):
            xi = x if dtype == torch.float32 else \
                [t.to(dtype) for t in x[:3]] + list(x[3:])
            name = (f"B={B} H={H} S={S} dh={dh} chunk={chunk} "
                    f"{str(dtype)[6:]}")
            fn = lambda: ml_ops.mlstm_scan(*xi, chunk=chunk)  # noqa: E731
            before = ml_ops.mlstm_scan.launches
            got = fn()
            if ml_ops.mlstm_scan.launches != before + 1:
                raise AssertionError(f"mlstm_scan past-limit {name}: the wrapper "
                                     f"did not launch the kernel once")
            want = mlstm_scan_ref(*xi, chunk=chunk)
            if dtype == torch.float32:
                err, form = _scan_close(f"mlstm_scan past-limit {name}", xi, chunk,
                                        got, want)
            else:
                err, form = _assert_close(f"mlstm_scan past-limit {name}", got, want,
                                          TOLS[dtype]), "elementwise"
            del got
            _, needed = kernel_bench.mlstm_flops(B, H, S, dh, chunk)
            t = _past_limit_time(f"mlstm_scan {name}", fn,
                         lambda: mlstm_scan_ref(*xi, chunk=chunk), None,
                         kernel_bench.mlstm_bytes(B, H, S, dh,
                                                  xi[0].element_size()),
                         needed, F32_FLOPS_PER_S, err,
                         why="no library call computes the mLSTM scan")
            t.update(check=form, bound_ms_3xtf32=kernel_bench
                     .mlstm_bound_3xtf32(B, H, S, dh, chunk),
                     cluster=p["cluster"], ctas=p["ctas"], cols=p["cols"],
                     key_slices=p["key_slices"], nt=p["nt"],
                     states_bytes=4 * B * H * (S // chunk - 1) * dh
                     * p["dhp"])
            t["previous_sm90"] = _against_previous(
                f"mlstm_scan past-limit {name}", fn,
                None if previous is None else
                (lambda: previous(*xi, chunk=chunk)), TOLS[dtype],
                K3_BASELINE, want=want, rtol_of_max=dtype == torch.float32)
            del want
            rows[name] = t
    return rows


def _mlstm_wide(rng, previous=None):
    """K3 at K3_WIDE_SHAPES, the cluster outputs pass's real widths: f32
    through ``_scan_close`` (dh=1024 also bf16 and f16 at their bars), each
    call launching the kernel once; one eager call and device ms
    (CUDA-graph replays) of the scan and of each pass alone (``passes``, one
    shared workspace) beside the 3xTF32 and f32-rate bounds (each product
    pass beside its own 3xTF32 bound), the cluster size and the card's most
    active such clusters; with ``previous`` (commit 774e907's K3, the
    sliced outputs pass) the scan and the outputs pass in turns with it.
    Then the scalar pass's share at chunk 1024 (dh=384). The inputs are
    drawn on the card (``kernel_bench.mlstm_inputs``'s distributions)."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))

    def inputs(B, H, S, dh):
        q, k, v = (torch.randn(B, H, S, dh, generator=gen, device="cuda")
                   for _ in range(3))
        u = torch.rand(B, H, S, generator=gen, device="cuda")
        lf = torch.log(0.5 + 0.49 * u)
        li = 0.5 * torch.randn(B, H, S, generator=gen, device="cuda")
        return q, k, v, lf, li

    rows = {}
    for B, H, S, dh, chunk in K3_WIDE_SHAPES:
        x = inputs(B, H, S, dh)
        name = f"B={B} H={H} S={S} dh={dh} chunk={chunk}"
        fn = lambda: ml_ops.mlstm_scan(*x, chunk=chunk)      # noqa: E731
        t = {"max_abs_err": {}, "check": None}
        types = ((torch.float32, torch.bfloat16, torch.float16) if dh == 1024
                 else (torch.float32,))
        for dtype in types:
            xi = x if dtype == torch.float32 else \
                [u.to(dtype) for u in x[:3]] + list(x[3:])
            before = ml_ops.mlstm_scan.launches
            got = ml_ops.mlstm_scan(*xi, chunk=chunk)
            if ml_ops.mlstm_scan.launches != before + 1:
                raise AssertionError(f"mlstm_scan wide {name}: the wrapper did "
                                     f"not launch the kernel once")
            want = mlstm_scan_ref(*xi, chunk=chunk)
            label = f"mlstm_scan wide {name} {str(dtype)[6:]}"
            if dtype == torch.float32:
                err, t["check"] = _scan_close(label, xi, chunk, got, want)
            else:
                err = _assert_close(label, got, want, TOLS[dtype])
            t["max_abs_err"][str(dtype)[6:]] = err
            del got, want, xi
        ws = ml_ops.workspace(B, H, S, dh, chunk, x[0].device)
        out = torch.empty_like(x[0])

        def run(p, x=x, chunk=chunk, ws=ws, out=out):
            return lambda: ml_ops._run_sm90(*x, chunk, ws=ws, out=out,
                                            passes=p)
        t["ms"] = _time_ms(fn, 5)
        t["device_ms"] = _device_ms(run(7), 5, 5)
        t["passes_device_ms"] = {n: _device_ms(run(p), 5, 5) for n, p in
                                 (("scalars", 1), ("states", 2),
                                  ("outputs", 4))}
        _, needed = kernel_bench.mlstm_flops(B, H, S, dh, chunk)
        t["bound_ms"], t["bound_by"] = bound_ms(
            kernel_bench.mlstm_bytes(B, H, S, dh), needed, F32_FLOPS_PER_S)
        t["bound_ms_3xtf32"] = kernel_bench.mlstm_bound_3xtf32(B, H, S, dh,
                                                               chunk)
        t["passes_bound_ms_3xtf32"] = kernel_bench.mlstm_pass_bounds_3xtf32(
            B, H, S, dh, chunk)
        t.update(ml_ops.clusters(dh, chunk))
        if previous is not None:
            _assert_close(f"mlstm_scan wide {name}: this build vs commit "
                          f"{K3_BASELINE}'s", fn(),
                          previous(*x, chunk=chunk), F32_TOL,
                          rtol_of_max=True)
            for n, p in (("scan", 7), ("outputs", 4)):
                mine, prev = _in_turns(run(p), lambda p=p: previous(
                    *x, chunk=chunk, ws=ws, out=out, passes=p))
                t[f"previous_{n}"] = {
                    "source_commit": K3_BASELINE, "device_ms": mine,
                    "previous_device_ms": prev,
                    "ratio": sum(mine) / sum(prev)}
        pb = t["passes_bound_ms_3xtf32"]
        pd = t["passes_device_ms"]
        prev_s = ("; commit {} in turns: scan {:.4f}, outputs {:.4f}".format(
            K3_BASELINE, t["previous_scan"]["ratio"],
            t["previous_outputs"]["ratio"]) if previous is not None else
            "; commit 774e907's: not measured (no --baseline-src)")
        print(f"[kernels] mlstm_scan wide {name} f32: {t['ms']:.4f} ms one "
              f"eager call, device {t['device_ms']:.4f} ms (scalars "
              f"{pd['scalars']:.4f}, states {pd['states']:.4f} ({pb['states'] / pd['states']:.3f} "
              f"of its 3xTF32 bound), outputs {pd['outputs']:.4f} "
              f"({pb['outputs'] / pd['outputs']:.3f})); bound "
              f"{t['bound_ms_3xtf32']:.4f} ms 3xTF32 "
              f"({t['bound_ms_3xtf32'] / t['device_ms']:.3f} of it) / "
              f"{t['bound_ms']:.4f} f32 rate; {t['cluster']} CTAs a cluster, "
              f"{t['ctas']} a row tile, at most {t['max_active_clusters']} "
              f"clusters active{prev_s}; max|err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in t["max_abs_err"].items())
              + f" ({t['check']})")
        rows[name] = t
        del x, ws, out
        torch.cuda.empty_cache()
    # the scalar pass at chunk 1024 (chunk_long_kernel), against the scan
    B, H, S, dh, chunk = 8, 4, 2048, 384, 1024
    x = inputs(B, H, S, dh)
    ws = ml_ops.workspace(B, H, S, dh, chunk, x[0].device)
    out = torch.empty_like(x[0])
    sc = {p: _device_ms(lambda p=p: ml_ops._run_sm90(
        *x, chunk, ws=ws, out=out, passes=p), 5, 5) for p in (1, 7)}
    rows["scalars B=8 H=4 S=2048 dh=384 chunk=1024"] = {
        "scalars_device_ms": sc[1], "device_ms": sc[7],
        "share": sc[1] / sc[7]}
    for name, r in rows.items():
        if "passes_device_ms" in r:
            r["scalars_share"] = r["passes_device_ms"]["scalars"] / \
                r["device_ms"]
    print(f"[kernels] mlstm_scan scalar pass at chunk 1024 (dh=384): "
          f"{sc[1]:.4f} of {sc[7]:.4f} ms device ({sc[1] / sc[7]:.3f}); at "
          f"chunk 512: " + ", ".join(
              f"{r['scalars_share']:.3f}" for n, r in rows.items()
              if n.endswith("chunk=512")))
    del x, ws, out
    return rows


def _flash_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Hq, Sq, d), rnd(B, Hkv, Sk, d), rnd(B, Hkv, Sk, d)


def _attention_f64(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The plain attention in float64, as the yardstick of f32 rounding
    (``attention_ref``'s math is float32)."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, Hkv, Hq // Hkv, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.double()) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                          device=q.device))
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1),
                       v.double())
    return out.reshape(B, Hq, Sq, d)


def _build_regs(name):
    """(registers, spill bytes) of the largest instantiation in
    ``csrc/<name>.cu``'s build log."""
    log = _build.build_log(name)
    return (max(int(w) for w in re.findall(r"Used (\d+) registers", log)),
            sum(int(w) for w in re.findall(r"(\d+) bytes spill", log)))


def phase_flash_kernels(baseline):
    """K2 against its plain version, both routes and both 2-byte types;
    returns the record. ``baseline`` (``benchmarks_torch/baselines.load``,
    maybe empty): the earlier CUDA-core f32 kernel and commit 076818b's two
    sm90 sources, timed beside the routes at the forward shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    units = {}

    def check(name, x, tol, **kw):
        errs[name] = _assert_close(f"flash_attention {name}",
                                   fa_ops.flash_attention(*x, **kw),
                                   attention_ref(*x, **kw), tol)
        units[name] = fa_ops._sm90_unit(*x)

    for dtype, tol in TOLS.items():
        for B, Hq, Hkv, Sq, Sk, d, causal, window, cap in FLASH_SWEEP:
            x = _flash_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype)
            check(f"(b) {str(dtype)[6:]} B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                  f"Sk={Sk} d={d} causal={causal} window={window} "
                  f"softcap={cap}", x, tol, causal=causal, window=window,
                  softcap=cap)
        check(f"(c) gemma2 widths d=256 GQA softcap 50 {str(dtype)[6:]}",
              _flash_inputs(gen, 2, 8, 4, 512, 512, 256, dtype), tol,
              softcap=50.0)
    # tails that are no multiple of a tile, and the model's strided views
    for dtype, tol in TOLS.items():
        name = str(dtype)[6:]
        check(f"(d) ragged Sq=Sk=200 window 70 d=80 {name}",
              _flash_inputs(gen, 1, 4, 2, 200, 200, 80, dtype), tol,
              window=70)
        check(f"(d) ragged non-causal Sq=72 Sk=136 d=48 {name}",
              _flash_inputs(gen, 2, 2, 1, 72, 136, 48, dtype), tol,
              causal=False)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
                 _flash_inputs(gen, 2, 6, 3, 192, 192, 64, dtype)]
        check(f"(d) strided (B,S,H,d) views {name}", views, tol)
        errs[f"(e) rows that see no key, causal Sq=256 Sk=64 window 32 "
             f"{name}"] = _check_no_key_rows(gen, 256, 64, 32, dtype, tol)
        # past d = 256 (slices of the output), both routes
        for d in (288, 320, 512, 1024):
            check(f"(h) d={d} GQA causal Sq=Sk=300 {name}",
                  _flash_inputs(gen, 1, 4, 2, 300, 300, d, dtype), tol)
        check(f"(h) d=320 non-causal softcap 50 Sq=130 Sk=150 {name}",
              _flash_inputs(gen, 2, 2, 2, 130, 150, 320, dtype), tol,
              causal=False, softcap=50.0)
        errs[f"(h) rows that see no key d=320 {name}"] = _check_no_key_rows(
            gen, 256, 64, 32, dtype, tol, d=320)
    # the f32 route's other loads: rows off 16-byte alignment, d = 37
    flat = torch.randn(2 * 100 * 64 + 1, generator=gen, device="cuda")
    q = _flash_inputs(gen, 1, 4, 2, 100, 100, 64, torch.float32)[0]
    check("(f) k, v 4 bytes off 16-byte alignment f32",
          (q, flat[1:].view(1, 2, 100, 64), flat[:-1].view(1, 2, 100, 64)),
          F32_TOL)
    check("(f) d=37 Sq=130 Sk=70 causal f32",
          _flash_inputs(gen, 1, 2, 1, 130, 70, 37, torch.float32), F32_TOL)
    # (i) the 2-byte route at head dims off 16 (TMA or the own loads),
    # bases 2 bytes off 16-byte alignment and strides TMA cannot step
    for dtype in (torch.bfloat16, torch.float16):
        name, tol = str(dtype)[6:], TOLS[dtype]
        for d in (37, 40, 72, 100):
            check(f"(i) d={d} Sq=130 Sk=70 causal {name}",
                  _flash_inputs(gen, 1, 4, 2, 130, 70, d, dtype), tol)
            n = 2 * 256 * d
            flat = torch.randn(3 * n + 1, generator=gen,
                               device="cuda").to(dtype)[1:]
            check(f"(i) d={d} q, k, v 2 bytes off alignment window 50 "
                  f"{name}", [flat[i * n:(i + 1) * n].view(1, 2, 256, d)
                              for i in range(3)], tol, window=50)
            rows = torch.randn(3, 2, 192, 3, d + 1, generator=gen,
                               device="cuda").to(dtype)[..., :d]
            check(f"(i) d={d} (B,S,H,d) views of rows of d+1 softcap 30 "
                  f"{name}", [t.transpose(1, 2) for t in rows], tol,
                  softcap=30.0)
        rows = torch.randn(3, 1, 150, 2, 331, generator=gen,
                           device="cuda").to(dtype)[..., :330]
        check(f"(i) d=330 views of rows of 331 (own loads, sliced) {name}",
              [t.transpose(1, 2) for t in rows], tol)
    print("[kernels] flash_attention max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))
    print("[kernels] flash_attention cases by unit (2-byte route: 16 TMA, "
          "8, 4, 2 own loads of that many bytes; f32: 16- or 4-byte "
          "copies): " + json.dumps(
              {u: sum(v == u for v in units.values()) for u in (16, 8, 4, 2)}))
    if not {8, 4, 2} <= set(units.values()):
        raise AssertionError(f"flash_attention: an own-load unit never "
                             f"ran: {sorted(set(units.values()))}")

    # (a) the forward's shape: Qwen1.5-4B attention at S=4096
    B, H, S, d = FWD_B, 20, FWD_S, 128
    x = _flash_inputs(gen, B, H, H, S, S, d, torch.bfloat16)
    want = attention_ref(*x)
    err_a = _assert_close("flash_attention (a) forward shape bf16",
                          fa_ops.flash_attention(*x), want, BF16_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # SDPA's bf16 path rounds the probabilities to bf16 before P.V, so it
    # sits further from the float32 plain version than K2 does
    _assert_close("sdpa yardstick", sdpa(*x, is_causal=True), want,
                  dict(atol=3e-2, rtol=5e-2))
    del want
    fn = lambda: fa_ops.flash_attention(*x)        # noqa: E731
    ms = _time_ms(fn, 20)
    dev_ms = _device_ms(fn, 10, 5)
    plain_ms = _time_ms(lambda: attention_ref(*x), 5)
    library_ms = _time_ms(lambda: sdpa(*x, is_causal=True), 20)
    prev_bf16 = _against_previous(
        "flash_attention forward shape bf16", fn,
        _previous(baseline, "flash_attention_sm90", x), BF16_TOL)
    elt = x[0].element_size()
    n_bytes = 4 * B * H * S * d * elt             # q, k, v in; out
    n_flops = kernel_bench.flash_flops(B, H, S, d)
    bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)
    cfg = fa_ops.kernel_config(torch.bfloat16, d)
    # the kernel's own work: whole 128 x 128 tiles up to the diagonal, and
    # P.V twice (P_hi and P_lo)
    n_qt = S // cfg["block_q"]
    tiles = B * H * sum((min((qt + 1) * cfg["block_q"], S) + cfg["block_k"]
                         - 1) // cfg["block_k"] for qt in range(n_qt))
    kernel_flops = tiles * cfg["block_q"] * cfg["block_k"] * d * 2 * 3
    regs, spills = _build_regs("flash_attention_sm90")
    print(f"[kernels] flash_attention forward shape B={B} H={H} S={S} d={d} "
          f"bf16 causal: {ms:.4f} ms eager, {dev_ms:.4f} ms device "
          f"({n_flops / dev_ms / 1e9:.1f} TFLOP/s of the function's "
          f"{n_flops / 1e9:.1f} GFLOP, "
          f"{kernel_flops / dev_ms / 1e9:.1f} TFLOP/s executed by the kernel: "
          f"{kernel_flops / 1e9:.1f} GFLOP with whole diagonal tiles and the "
          f"split P.V), bound {bound:.4f} ms at the bf16 tensor-core peak; "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; max|err| "
          f"{err_a:.3e}; 2-byte kernel: {cfg['block_q']} q rows x "
          f"{cfg['block_k']} keys per tile, 384 threads, registers <= "
          f"{regs} (launch), {cfg['smem_bytes']} B dynamic shared memory, "
          f"spill bytes {spills} (all instances)")

    # (j) the float16 route at the forward shape: the same inputs in f16
    xh = [t.half() for t in x]
    fh = lambda: fa_ops.flash_attention(*xh)       # noqa: E731
    lib_h = lambda: sdpa(*xh, is_causal=True)      # noqa: E731
    err_h = _assert_close("flash_attention (j) forward shape f16", fh(),
                          attention_ref(*xh), F16_TOL)
    f16 = {"dtype": "float16", "launches": None, "ms": _time_ms(fh, 20),
           "device_ms": _device_ms(fh, 10, 5),
           "plain_ms": _time_ms(lambda: attention_ref(*xh), 5),
           "library_ms": _time_ms(lib_h, 20),
           "library_device_ms": _device_ms(lib_h, 10, 5),
           "max_abs_err": err_h, "bound_ms": bound, "bound_by": by,
           "source": "src/repro_torch/csrc/flash_attention_sm90.cu"}
    f16["previous_sm90"] = _against_previous(
        "flash_attention forward shape f16", fh,
        _previous(baseline, "flash_attention_sm90", xh), F16_TOL)
    del xh
    print(f"[kernels] flash_attention forward shape f16 (one P.V product): "
          f"{f16['ms']:.4f} ms eager, {f16['device_ms']:.4f} ms device "
          f"({n_flops / f16['device_ms'] / 1e9:.1f} TFLOP/s); sdpa "
          f"is_causal on the same inputs {f16['library_ms']:.4f} ms eager, "
          f"{f16['library_device_ms']:.4f} ms device; bound {bound:.4f} ms "
          f"(the fp16 tensor-core rate, the bf16 one); plain "
          f"{f16['plain_ms']:.4f} ms; max|err| {err_h:.3e}")

    # (g) the f32 route at the forward shape: the same inputs in f32
    xf = [t.float() for t in x]
    del x
    got = fa_ops.flash_attention(*xf)
    want = attention_ref(*xf)
    err_f = _assert_close("flash_attention (g) forward shape f32", got, want,
                          F32_TOL)
    want64 = _attention_f64(*xf)
    err_f64 = _assert_close("flash_attention (g) forward shape f32 vs "
                            "float64", got, want64, F32_TOL)
    err_ref64 = float((want.double() - want64).abs().max())
    del want, want64
    fn = lambda: fa_ops.flash_attention(*xf)       # noqa: E731
    lib = lambda: sdpa(*xf, is_causal=True)        # noqa: E731
    f32 = {"ms": _time_ms(fn, 20), "device_ms": _device_ms(fn, 10, 5),
           "plain_ms": _time_ms(lambda: attention_ref(*xf), 5),
           "library_ms": _time_ms(lib, 10),
           "library_device_ms": _device_ms(lib, 10, 5)}
    prev = None
    old = baseline.get("flash_attention")
    if old is not None:
        prev = {"max_abs_err_vs_new": _assert_close(
                    "earlier f32 kernel vs the f32 route", old(*xf), got,
                    F32_TOL),
                "ms": _time_ms(lambda: old(*xf), 5),
                "device_ms": _device_ms(lambda: old(*xf), 5, 3)}
    prev_f32 = _against_previous(
        "flash_attention forward shape f32", fn,
        _previous(baseline, "flash_attention_f32_sm90", xf), F32_TOL)
    f32["ms_2"] = _time_ms(fn, 20)                 # the route again, last
    f32["device_ms_2"] = _device_ms(fn, 10, 5)
    del xf, got
    # the f32 route's bound is at the rate it runs: three TF32 tensor-core
    # products for each f32 product; the f32 rate's is kept beside it
    tf32_bound, tf32_by = bound_ms(2 * n_bytes, 3 * n_flops, TF32_FLOPS_PER_S)
    f32_bound = bound_ms(2 * n_bytes, n_flops, F32_FLOPS_PER_S)[0]
    cfg32 = fa_ops.kernel_config(torch.float32, d)
    regs32, spills32 = _build_regs("flash_attention_f32_sm90")
    routes = {
        "bf16": {"dtype": "bfloat16", "launches": None, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 "max_abs_err": err_a, "bound_ms": bound, "bound_by": by,
                 "library_ms": library_ms, "previous_sm90": prev_bf16,
                 "source": "src/repro_torch/csrc/flash_attention_sm90.cu"},
        "f16": f16,
        "f32": {"dtype": "float32", "launches": None, "ms": f32["ms"],
                "device_ms": f32["device_ms"], "plain_ms": f32["plain_ms"],
                "max_abs_err": err_f, "max_abs_err_vs_f64": err_f64,
                "plain_f32_vs_f64": err_ref64, "bound_ms": tf32_bound,
                "bound_by": tf32_by, "bound_f32_rate_ms": f32_bound,
                "library_ms": f32["library_ms"],
                "library_device_ms": f32["library_device_ms"],
                "earlier_kernel": prev, "previous_sm90": prev_f32,
                "source": "src/repro_torch/csrc/flash_attention_f32_sm90.cu"}}
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
           "launches": None, "max_abs_err": err_a, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms, "routes": routes,
           "shapes": _flash_other_shapes(gen, baseline),
           "past_limit_shapes": _flash_past_limits(gen)}
    prev_s = ("not measured (no --baseline-src)" if prev is None else
              f"{prev['ms']:.4f} ms eager, {prev['device_ms']:.4f} ms device")
    print(f"[kernels] flash_attention forward shape f32 (3xTF32 route): "
          f"{f32['ms']:.4f} / {f32['ms_2']:.4f} ms eager, "
          f"{f32['device_ms']:.4f} / {f32['device_ms_2']:.4f} ms device "
          f"({3 * n_flops / f32['device_ms'] / 1e9:.1f} TFLOP/s of 3xTF32 "
          f"products); sdpa on the same inputs {f32['library_ms']:.4f} ms "
          f"eager, {f32['library_device_ms']:.4f} ms device; the earlier "
          f"CUDA-core kernel {prev_s}; bound {tf32_bound:.4f} ms (3xTF32 at the "
          f"TF32 rate; {f32_bound:.4f} ms at the f32 rate); plain "
          f"{f32['plain_ms']:.4f} ms; max|err| vs plain {err_f:.3e}, vs "
          f"float64 {err_f64:.3e} (plain f32 vs float64 {err_ref64:.3e}); "
          f"f32 kernel: {cfg32['block_q']} q rows x {cfg32['block_k']} keys "
          f"per tile, registers <= {regs32}, {cfg32['smem_bytes']} B dynamic "
          f"shared memory, spill bytes {spills32}")
    return rec


def _previous(baseline, name, x):
    """commit 076818b's K2 source ``name`` on x, or None."""
    old = baseline.get(name)
    return None if old is None else (lambda: old(*x))


# K2 timed past the forward's shape: gemma2's d = 256 (the widest tile of
# one CTA), head dims past 256 (the output's slices; on the f32 route a
# cluster of 4 CTAs of 128 columns at d = 512, of 5 of 256 at d = 1280, and
# past one cluster's reach at d = 2304: 18 slices of 128, three groups of
# 8, the last padded), and SigLIP-so400m's vision tower (1152 / 16 = 72,
# 729 patches, no mask) by TMA and by the own loads (rows of 73)
FLASH_SHAPES = {
    "d256 B=1 H=8 S=2048 causal": (1, 8, 2048, 256, True, 0),
    "d512 B=1 H=8 S=2048 causal": (1, 8, 2048, 512, True, 0),
    "d1280 B=1 H=4 S=1024 causal": (1, 4, 1024, 1280, True, 0),
    "d2304 B=1 H=2 S=512 causal": (1, 2, 512, 2304, True, 0),
    "siglip d72 B=8 H=16 S=729 non-causal": (8, 16, 729, 72, False, 0),
    "siglip d72 rows of 73 (own loads)": (8, 16, 729, 72, False, 1),
}


def _flash_other_shapes(gen, baseline):
    """K2 at FLASH_SHAPES, every route: eager and device ms beside the
    bound (the dtype's tensor-core rate; 3xTF32 at the TF32 rate for f32),
    the plain version and SDPA on the same inputs; with ``baseline``
    (commit 076818b's sources) that route's kernel in turns. The f32 route
    past d = 256 (the cluster route): its slice width, cluster size and the
    card's most active such clusters (``f32_clusters``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (B, H, S, d, causal, pad) in FLASH_SHAPES.items():
        for dtype in TOLS:
            rows = torch.randn(3, B, S, H, d + pad, generator=gen,
                               device="cuda").to(dtype)[..., :d]
            x = [t.transpose(1, 2) for t in rows]
            if not pad:
                x = [t.contiguous() for t in x]
            fn = lambda: fa_ops.flash_attention(*x, causal=causal)  # noqa
            lib = lambda: sdpa(*x, is_causal=causal)               # noqa
            # SDPA's kernels refuse rows off 16-byte alignment: no library
            # call computes the own-load inputs
            want = attention_ref(*x, causal=causal)
            err = _assert_close(f"flash_attention {name} {dtype}", fn(),
                                want, TOLS[dtype])
            pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
            n_flops, n_bytes = 4 * d * pairs, 4 * B * H * S * d * \
                x[0].element_size()
            f32 = dtype == torch.float32
            b, by = bound_ms(n_bytes, 3 * n_flops if f32 else n_flops,
                             TF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S)
            key = f"{name} {str(dtype)[6:]}"
            r = {"unit": fa_ops._sm90_unit(*x), "max_abs_err": err,
                 "ms": _time_ms(fn, 5), "device_ms": _device_ms(fn, 5, 3),
                 "plain_ms": _time_ms(lambda: attention_ref(
                     *x, causal=causal), 3),
                 "library_device_ms": None if pad else _device_ms(lib, 5, 3),
                 "bound_ms": b, "bound_by": by}
            if f32 and d > 256:
                r.update(fa_ops.f32_clusters(d))
                print(f"[kernels] flash_attention {key}: the cluster route, "
                      f"slices of {r['cols']} columns, {r['cluster']} CTAs "
                      f"a cluster, at most {r['max_active_clusters']} such "
                      f"clusters active at once (cudaOccupancyMaxActive"
                      f"Clusters)")
            r["previous"] = _against_previous(
                f"flash_attention {key}", fn, None if baseline.get(
                    fa_ops.SOURCES[dtype]) is None else (
                    lambda: baseline[fa_ops.SOURCES[dtype]](
                        *x, causal=causal)), TOLS[dtype], want=want)
            out[key] = r
            lib_s = ("none" if pad else
                     f"{r['library_device_ms']:.4f} ms device")
            print(f"[kernels] flash_attention {name} {str(dtype)[6:]} "
                  f"(unit {r['unit']}): {r['ms']:.4f} ms eager, "
                  f"{r['device_ms']:.4f} ms device, "
                  f"bound {b:.4f} ms ({by}; {b / r['device_ms']:.3f} of "
                  f"it), sdpa {lib_s}, plain {r['plain_ms']:.4f} ms; "
                  f"max|err| {err:.3e}")
            del x, rows, want
        torch.cuda.empty_cache()
    return out


def _check_no_key_rows(gen, Sq, Sk, window, dtype, tol, d=64):
    """Causal with a window, Sk < Sq: rows q >= Sk + window - 1 see no key.
    Rows that see one are held against the plain version; the others
    against the kernel's convention, the mean of v over the keys of the
    tiles their q tile visited (or 0 when it visited none)."""
    x = _flash_inputs(gen, 1, 2, 2, Sq, Sk, d, dtype)
    got = fa_ops.flash_attention(*x, window=window)
    want = attention_ref(*x, window=window).float()
    cfg = fa_ops.kernel_config(dtype, d)
    bq, bk = cfg["block_q"], cfg["block_k"]
    v = x[2].float()
    blind = 0
    for qp in range(Sq):
        if max(0, qp - window + 1) <= min(qp, Sk - 1):
            continue                      # the row sees a key
        blind += 1
        q0 = qp // bq * bq
        k_end = min(Sk, q0 + bq, Sq)
        k_first = max(0, q0 - window + 1) // bk * bk
        n_tiles = max(0, -(-(k_end - k_first) // bk))
        keys = v[:, :, k_first:min(Sk, k_first + n_tiles * bk)]
        want[:, :, qp] = keys.mean(2) if keys.shape[2] else 0.0
    if not blind:
        raise AssertionError("no-key check: every row sees a key")
    return _assert_close(f"flash_attention (e) {blind} of {Sq} rows see no "
                         f"key, {str(dtype)[6:]} ({bq} x {bk} tiles)", got,
                         want.to(dtype), tol)


def _scan_f64(q, k, v, lf, li, chunk):
    """The plain mLSTM scan in float64, as the yardstick of f32 rounding."""
    B, H, _, dh = q.shape
    f64 = dict(dtype=torch.float64, device=q.device)
    h, _ = xlstm.mlstm_chunk_scan(
        q.double(), k.double(), v.double(), lf.double(), li.double(),
        (torch.zeros((B, H, dh, dh), **f64), torch.zeros((B, H, dh), **f64),
         torch.full((B, H), xlstm.MMIN, **f64)), chunk=chunk)
    return h


def _scan_close(name, x, chunk, got, want):
    """K3 against its plain version at the f32 tolerance, elementwise.

    Where that fails, both are held against the same scan in float64: when
    the f32 plain version is itself at least half the elementwise bound away
    from it, the bound is below the rounding of float32 sums over dh and the
    chunk, and the rtol is taken of max |h| instead (the reason is printed);
    otherwise the failure stands. Returns (max |err|, the form used)."""
    try:
        return _assert_close(name, got, want, F32_TOL), "elementwise"
    except AssertionError as e:
        exact = _scan_f64(*x, chunk)
        plain, kern = (kernel_bench.compare(t, exact)[1] for t in (want, got))
        del exact
        if plain < 0.5:
            raise
        form = (f"rtol of max |h|: against the float64 scan the f32 plain "
                f"version is {plain:.3f}x the elementwise bound, the kernel "
                f"{kern:.3f}x")
        print(f"[kernels] {e}; {form}")
        return _assert_close(name, got, want, F32_TOL, rtol_of_max=True), form


def _k3_edge_cases(rng):
    """K3 inputs that reach the kernel's edges: (name, inputs, chunk, tol)."""
    def gates(x, li):
        return list(x[:4]) + [torch.from_numpy(li.astype(np.float32)).cuda()]
    cases = []
    # lf strongly negative and li near -42: most log weights fall under -40,
    # so m_i and the carried m sit at the floor in some rows and chunks
    for B, H, S, dh, chunk in ((1, 2, 128, 16, 32), (2, 4, 512, 96, 128)):
        x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda", (1e-8, 1e-6))
        cases.append((f"(e) m at its floor B={B} H={H} S={S} dh={dh} "
                      f"chunk={chunk}", gates(x, rng.randn(B, H, S) * 2 - 42),
                      chunk, F32_TOL))
    # two large input gates: the carried state sets m_i for whole chunks,
    # then a key of a later chunk takes over
    for B, H, S, dh, chunk in ((1, 1, 256, 64, 64), (1, 4, 1024, 384, 256)):
        x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda", (0.9, 0.99))
        li = rng.randn(B, H, S) * 0.5
        li[..., 3], li[..., 2 * chunk + 5] = 12.0, 15.0
        cases.append((f"(f) the stabilizer switches B={B} H={H} S={S} "
                      f"dh={dh} chunk={chunk}", gates(x, li), chunk, F32_TOL))
    # the widest head and chunk: the most shared memory per block
    x = kernel_bench.mlstm_inputs(rng, 1, 2, 512, 512, "cuda")
    cases.append(("(g) dh=512 chunk=256 f32", x, 256, F32_TOL))
    cases.append(("(g) dh=512 chunk=256 bf16",
                  [t.bfloat16() for t in x[:3]] + list(x[3:]), 256,
                  BF16_TOL))
    # rows read element by element: dh not a multiple of 4, and bases 4
    # bytes off 16-byte alignment
    x = kernel_bench.mlstm_inputs(rng, 2, 2, 128, 6, "cuda")
    cases.append(("(h) dh=6 chunk=64 f32", x, 64, F32_TOL))
    cases.append(("(h) dh=6 chunk=64 bf16",
                  [t.bfloat16() for t in x[:3]] + list(x[3:]), 64, BF16_TOL))
    x = list(kernel_bench.mlstm_inputs(rng, 1, 3, 256, 64, "cuda"))
    for i in range(3):
        flat = torch.empty(x[i].numel() + 1, device="cuda")
        x[i] = flat[1:].view(x[i].shape).copy_(x[i])
    cases.append(("(h) q, k, v 4 bytes off alignment chunk=128", x, 128,
                  F32_TOL))
    cases.append(("(i) chunk=1",
                  kernel_bench.mlstm_inputs(rng, 1, 2, 16, 8, "cuda"), 1,
                  F32_TOL))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
             kernel_bench.mlstm_inputs(rng, 2, 3, 128, 48, "cuda")]
    cases.append(("(d) strided (B,S,H,dh) views bf16 chunk=64",
                  [t.bfloat16() for t in views[:3]] + views[3:], 64,
                  BF16_TOL))
    return cases


def phase_mlstm_kernels(baselines):
    """K3 against its plain version; the xLSTM-125m layer shape and the
    kernel bench's shapes timed, beside the earlier CUDA-core kernel and
    commit 076818b's K3 where ``baselines`` (``baselines.load``) gives
    them. Returns the layer-shape record."""
    baseline = baselines.get("mlstm_scan")
    rng = np.random.RandomState(3)
    errs = {}

    def check(name, x, chunk, tol, plain_chunk=None):
        got = ml_ops.mlstm_scan(*x, chunk=chunk)
        want = mlstm_scan_ref(*x, chunk=plain_chunk or chunk)
        if tol is F32_TOL:
            errs[name] = _scan_close(f"mlstm_scan {name}", x, chunk, got,
                                     want)[0]
        else:
            errs[name] = _assert_close(f"mlstm_scan {name}", got, want, tol)

    for B, H, S, dh, chunk in MLSTM_SWEEP:
        x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda")
        name = f"B={B} H={H} S={S} dh={dh} chunk={chunk}"
        check(f"(b) f32 {name}", x, chunk, F32_TOL)
        # as tests/test_kernels.py: the plain version at another chunk
        check(f"(b) f32 {name} vs plain chunk 8", x, chunk, F32_TOL, 8)
        bf = [t.bfloat16() for t in x[:3]] + list(x[3:])
        check(f"(c) bf16 {name}", bf, chunk, BF16_TOL)
        check(f"(c) f16 {name}", [t.half() for t in x[:3]] + list(x[3:]),
              chunk, F16_TOL)
    # tests/test_kernels.py:118-131's property inputs and tolerance
    x = kernel_bench.mlstm_inputs(rng, 1, 2, 48, 8, "cuda", (0.3, 0.999), 1.0)
    check("(b) f32 property B=1 H=2 S=48 dh=8 chunk=16 vs plain chunk 48", x,
          16, dict(atol=5e-5, rtol=5e-4), 48)
    for B, H, S, dh, chunk in kernel_bench.MLSTM_SHAPES:
        check(f"(d) f32 kernel-bench widths B={B} H={H} S={S} dh={dh} "
              f"chunk={chunk}",
              kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda"), chunk,
              F32_TOL)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in
             kernel_bench.mlstm_inputs(rng, 2, 3, 128, 48, "cuda")]
    check("(d) strided (B,S,H,dh) views f32 chunk=32", views, 32, F32_TOL)
    for name, x, chunk, tol in _k3_edge_cases(rng):
        check(name, x, chunk, tol)
    print("[kernels] mlstm_scan max|err| " + "; ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))

    # (a) the xLSTM-125m mLSTM layer's shape, at the model's chunk (256) and
    # the kernel's default (128)
    B, H, S, dh = XLSTM_B, 4, XLSTM_S, 384
    x = kernel_bench.mlstm_inputs(rng, B, H, S, dh, "cuda")
    src = "src/repro_torch/csrc/mlstm_scan_sm90.cu"
    rec = {"name": "mlstm_scan", "route": "cuda", "source": src,
           "replaces": "src/repro/kernels/mlstm_scan/kernel.py:74",
           "launches": None, "library_ms": None,
           "timing": "ms: one call between two CUDA events, host work "
                     "included; device_ms: device time per call, CUDA-graph "
                     "replays; passes_device_ms: each pass alone, the same "
                     "way"}
    for chunk in (XLSTM_CHUNK, 128):
        fn = lambda: ml_ops.mlstm_scan(*x, chunk=chunk)     # noqa: E731
        err, form = _scan_close(
            f"mlstm_scan (a) layer shape chunk={chunk} f32", x, chunk, fn(),
            mlstm_scan_ref(*x, chunk=chunk))
        ms = _time_ms(fn, 10)
        dev_ms = _device_ms(fn, 5, 5)
        ws = ml_ops.workspace(B, H, S, dh, chunk, x[0].device)
        out = torch.empty_like(x[0])
        ml_ops._run_sm90(*x, chunk, ws=ws, out=out)
        passes = {name: _device_ms(lambda: ml_ops._run_sm90(
            *x, chunk, ws=ws, out=out, passes=p), 5, 5)
            for name, p in (("scalars", 1), ("states", 2), ("outputs", 4))}
        del ws, out
        plain_ms = _time_ms(lambda: mlstm_scan_ref(*x, chunk=chunk), 5)
        full, needed = kernel_bench.mlstm_flops(B, H, S, dh, chunk)
        bound, by = bound_ms(kernel_bench.mlstm_bytes(B, H, S, dh), needed,
                             F32_FLOPS_PER_S)
        bound3 = kernel_bench.mlstm_bound_3xtf32(B, H, S, dh, chunk)
        prev = _k3_previous(baseline, x, chunk, fn())
        sfx = "" if chunk == XLSTM_CHUNK else f"_chunk{chunk}"
        if chunk == XLSTM_CHUNK:
            old = baselines.get("mlstm_scan_sm90")
            rec["previous_sm90"] = _against_previous(
                f"mlstm_scan layer shape f32 chunk {chunk}", fn,
                None if old is None else (lambda: old(*x, chunk=chunk)),
                F32_TOL, K3_BASELINE, rtol_of_max=True)
        rec.update({f"max_abs_err{sfx}": err, f"check{sfx}": form,
                    f"ms{sfx}": ms, f"device_ms{sfx}": dev_ms,
                    f"passes_device_ms{sfx}": passes,
                    f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": bound,
                    f"bound_by{sfx}": by, f"bound_ms_3xtf32{sfx}": bound3,
                    f"previous_kernel{sfx}": prev})
        print(f"[kernels] mlstm_scan layer shape B={B} H={H} S={S} dh={dh} "
              f"chunk={chunk} f32: {ms:.4f} ms one eager call, device "
              f"{dev_ms:.4f} ms (scalars {passes['scalars']:.4f}, states "
              f"{passes['states']:.4f}, outputs {passes['outputs']:.4f}); "
              f"{needed / ms / 1e9:.1f} TFLOP/s of {needed / 1e9:.2f} GFLOP "
              f"needed; bound {bound:.4f} ms ({by}, f32 rate; "
              f"{bound / ms:.3f} of it), {bound3:.4f} ms at the 3xTF32 rate "
              f"({bound3 / ms:.3f}); plain {plain_ms:.4f} ms; earlier "
              f"CUDA-core kernel {_k3_fmt(prev)}; max|err| {err:.3e} "
              f"({form})")
        if ms > 2 * bound:
            print(f"[kernels] note: one eager call at chunk {chunk} is "
                  f"under half the f32 bound")
    # float16 at the layer shape, chunk 256: the same inputs
    xh = [t.half() for t in x[:3]] + list(x[3:])
    fh = lambda: ml_ops.mlstm_scan(*xh, chunk=XLSTM_CHUNK)   # noqa: E731
    rec["f16"] = {"max_abs_err": _assert_close(
        "mlstm_scan (a) layer shape chunk=256 f16", fh(),
        mlstm_scan_ref(*xh, chunk=XLSTM_CHUNK), F16_TOL),
        "ms": _time_ms(fh, 10), "device_ms": _device_ms(fh, 5, 5),
        "plain_ms": _time_ms(lambda: mlstm_scan_ref(*xh, chunk=XLSTM_CHUNK),
                             5),
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None}
    del xh
    print(f"[kernels] mlstm_scan layer shape chunk={XLSTM_CHUNK} f16: "
          f"{rec['f16']['ms']:.4f} ms one eager call, device "
          f"{rec['f16']['device_ms']:.4f} ms; plain "
          f"{rec['f16']['plain_ms']:.4f} ms; max|err| "
          f"{rec['f16']['max_abs_err']:.3e}")
    bench = {}
    for B_, H_, S_, dh_, chunk in kernel_bench.MLSTM_SHAPES:
        xb = kernel_bench.mlstm_inputs(np.random.RandomState(0), B_, H_, S_,
                                       dh_, "cuda")
        fn = lambda: ml_ops.mlstm_scan(*xb, chunk=chunk)    # noqa: E731
        name = f"B{B_}H{H_}S{S_}dh{dh_}c{chunk}"
        bench[name] = {"ms": _time_ms(fn, 20), "device_ms": _device_ms(fn),
                       "previous_kernel": _k3_previous(baseline, xb, chunk,
                                                       fn())}
        old = baselines.get("mlstm_scan_sm90")
        bench[name]["previous_sm90"] = _against_previous(
            f"mlstm_scan kernel bench {name}", fn,
            None if old is None else (lambda: old(*xb, chunk=chunk)),
            F32_TOL, K3_BASELINE, rtol_of_max=True)
        b = bench[name]
        print(f"[kernels] mlstm_scan kernel bench {name}: {b['ms']:.4f} ms "
              f"one eager call, device {b['device_ms']:.4f} ms; earlier "
              f"CUDA-core kernel {_k3_fmt(b['previous_kernel'])}")
        prev = b["previous_kernel"]
        if prev and b["device_ms"] > prev["device_ms"]:
            print(f"[kernels] note: at {name} the sm90 kernel is slower in "
                  f"device ms than the earlier kernel")
    rec["kernel_bench_shapes"] = bench
    old = baselines.get("mlstm_scan_sm90")
    rec["past_limit_shapes"] = _mlstm_past_limits(rng, old)
    rec["wide_shapes"] = _mlstm_wide(rng, old)
    return rec


def _k3_previous(baseline, x, chunk, want):
    """The earlier CUDA-core K3 kernel on the same inputs: checked against
    the sm90 kernel's output ``want`` (rtol of max |h|), timed as one eager
    call and in device time; None without a baseline checkout."""
    if baseline is None:
        return None
    fn = lambda: baseline(*x, chunk=chunk)      # noqa: E731
    err = _assert_close("earlier K3 kernel vs the sm90 kernel", fn(), want,
                        F32_TOL, rtol_of_max=True)
    return {"ms": _time_ms(fn, 5), "device_ms": _device_ms(fn, 5, 3),
            "max_abs_err_vs_sm90": err}


def _k3_fmt(prev):
    if prev is None:
        return "not measured (no --baseline-src)"
    return (f"{prev['ms']:.4f} ms eager, {prev['device_ms']:.4f} ms device")


def phase_small_input():
    """The example's reduced model: kernel path on the card against the
    plain path on the CPU, from the same weights; same generated tokens."""
    ex = _example()
    cfg = ex.example_config()
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    toks = {}
    for dev in ("cpu", "cuda"):
        out = {}
        for rec in ex.serve(cfg, _tree_to(params, dev), dev,
                            ex.example_requests()):
            out.update({r.rid: g for r, g in rec["finished"]})
        toks[dev] = out
    if toks["cpu"] != toks["cuda"] or len(toks["cuda"]) != 7:
        raise AssertionError(f"small input: card {toks['cuda']} != "
                             f"cpu {toks['cpu']}")
    print(f"[serve] small input: 7 requests, card tokens == cpu tokens")


def phase_small_forward():
    """Reduced Qwen (2 layers, head_dim 32), f32: the forward and loss with
    use_pallas on the card (K2's f32 route) against the same on the CPU
    (plain)."""
    cfg = reduced(get_config("qwen1.5-4b"), n_layers=2, head_dim=32)
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    before = fa_ops.flash_attention.launches
    before_bf16 = fa_ops.flash_attention.launches_bf16
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            logits, _ = lm.forward_train(p, cfg, run, b)
            loss = get_model(cfg).train_loss(p, run, b)
            out[dev] = (logits.cpu(), loss.cpu())
    if fa_ops.flash_attention.launches - before != 2 * cfg.n_layers:
        raise AssertionError("small forward: K2 did not run on the card")
    if fa_ops.flash_attention.launches_bf16 != before_bf16:
        raise AssertionError("small forward: f32 took the bf16 route")
    err = _assert_close("small forward logits, card vs cpu", out["cuda"][0],
                        out["cpu"][0], F32_TOL)
    err_l = _assert_close("small forward loss, card vs cpu", out["cuda"][1],
                          out["cpu"][1], F32_TOL)
    print(f"[forward] small input: reduced qwen B=2 S=128 f32, logits "
          f"max|err| {err:.3e}, loss {float(out['cuda'][1]):.6f} (cpu "
          f"{float(out['cpu'][1]):.6f}, |err| {err_l:.3e})")


def phase_small_xlstm():
    """Reduced xLSTM (5 layers: sLSTM at 0 and 4), f32: the forward and loss,
    and prefill plus 4 greedy decode steps, on the card against the CPU."""
    cfg = reduced(get_config("xlstm-125m"), n_layers=5)
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="float32")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            logits, _ = xlstm.forward_train(p, cfg, run, b)
            loss = bundle.train_loss(p, run, b)
            lg, cache, lens = bundle.prefill(p, run, None, b["tokens"])
            gen = [lg.argmax(-1)]
            for _ in range(4):
                lg, cache = bundle.decode_step(p, run, cache, gen[-1], lens)
                lens = lens + 1
                gen.append(lg.argmax(-1))
            out[dev] = (logits.cpu(), loss.cpu(), torch.stack(gen, 1).cpu())
    err = _assert_close("small xlstm logits, card vs cpu", out["cuda"][0],
                        out["cpu"][0], F32_TOL)
    err_l = _assert_close("small xlstm loss, card vs cpu", out["cuda"][1],
                          out["cpu"][1], F32_TOL)
    if not torch.equal(out["cuda"][2], out["cpu"][2]):
        raise AssertionError(f"small xlstm: card tokens {out['cuda'][2]} != "
                             f"cpu tokens {out['cpu'][2]}")
    print(f"[xlstm] small input: reduced xlstm 5 layers B=2 S=96 f32, logits "
          f"max|err| {err:.3e}, loss {float(out['cuda'][1]):.6f} (|err| "
          f"{err_l:.3e}); prefill + 4 decode steps: card tokens == cpu "
          f"tokens {out['cpu'][2].tolist()}")


def phase_serve():
    ex = _example()
    cfg = get_config("qwen1.5-4b")
    assert cfg.n_layers == SERVE_LAYERS_PER_STEP
    run = RunConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params (bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    requests = generate_requests(default_clients(), SERVE_HORIZON_MS, seed=0)
    kind = {r.rid: default_clients()[r.client].kind for r in requests}
    calls = {"n": 0, "plain_err": None, "attn_err": 0.0, "argmax": None}

    def checked_attention(*args, softcap):
        """The served kernel call, held at each layer against the plain
        version on the same inputs (float32 pools: the f32 tolerance)."""
        out = ops.paged_attention(*args, softcap=softcap)
        err = _assert_close("serve step attention vs plain", out,
                            paged_attention_ref(*args, softcap=softcap),
                            F32_TOL)
        calls["attn_err"] = max(calls["attn_err"], err)
        return out

    def decode(params, cfg, run, pools, tok, pos, pt, *, page_size):
        if calls["n"] != SERVE_CHECK_STEP:
            logits, pools = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size)
        else:
            # The plain step writes the same pool slots the kernel step
            # then rewrites, so the pools end as the kernel step alone
            # leaves them.
            plain, _ = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size,
                attention=paged_attention_ref)
            logits, pools = paged_lm.paged_decode_step(
                params, cfg, run, pools, tok, pos, pt, page_size=page_size,
                attention=checked_attention)
            # 40 bf16 layers: rounding flips of the attention output move
            # the bf16 residual stream by its ulp, so near-zero logits
            # differ by more than an elementwise rtol allows; the rtol is
            # taken of the logits' largest magnitude.
            calls["plain_err"] = _assert_close(
                "serve step logits vs plain attention", logits, plain,
                BF16_TOL, rtol_of_max=True)
            calls["argmax"] = float((logits.argmax(-1) == plain.argmax(-1))
                                    .float().mean())
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"non-finite logits at step {calls['n']}")
        calls["n"] += 1
        return logits, pools

    torch.cuda.reset_peak_memory_stats()
    finished, step_s, tokens = [], [], 0
    _zero_counts()
    t_prev = time.perf_counter()
    stream = ex.serve(cfg, params, "cuda", requests, SERVE_SLOTS, run=run,
                      page_size=SERVE_PAGE, n_pages=SERVE_PAGES, decode=decode)
    for rec in stream:
        t_now = time.perf_counter()
        if rec["step"] not in (0, SERVE_CHECK_STEP):   # warm-up, check step
            step_s.append(t_now - t_prev)
            tokens += rec["batch"]
        t_prev = t_now
        finished += [kind[r.rid] for r, _ in rec["finished"]]
        if len(finished) >= 8 and "bulk" in finished \
                and "interactive" in finished:
            break
        if rec["step"] + 1 >= SERVE_STEP_CAP:
            raise AssertionError(f"step cap {SERVE_STEP_CAP}: finished "
                                 f"{finished}")
    launches = ops.paged_attention.launches
    if ops.paged_attention.launches_mma:
        raise AssertionError("serving decode (g = 1) took K1's mma route")
    stream.close()                     # frees the KV pools
    if fa_ops.flash_attention.launches:
        raise AssertionError("serving decode launched flash_attention")
    steps = rec["step"] + 1
    if launches != SERVE_LAYERS_PER_STEP * steps:
        raise AssertionError(f"paged_attention launches {launches} != "
                             f"{SERVE_LAYERS_PER_STEP} x {steps} steps")
    if calls["plain_err"] is None:
        raise AssertionError("the plain-attention check step never ran")
    total = sum(step_s)
    print(f"[serve] steps {steps}, finished {len(finished)} "
          f"({finished.count('bulk')} bulk, "
          f"{finished.count('interactive')} interactive), decode "
          f"{tokens / total:.1f} tok/s, mean step {1e3 * total / len(step_s):.3f}"
          f" ms, median step {1e3 * statistics.median(step_s):.3f} ms, "
          f"paged_attention launches {launches}; step {SERVE_CHECK_STEP}: "
          f"attention vs plain max|err| {calls['attn_err']:.3e} (40 layers),"
          f" logits vs plain-attention step max|err| "
          f"{calls['plain_err']:.3e}, argmax agreement {calls['argmax']:.3f};"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, params


FWD_ROUTES = {torch.bfloat16: ("bf16", "launches_bf16"),
              torch.float16: ("f16", "launches_f16"),
              torch.float32: ("f32", None)}


def phase_forward(params, flash_ms, dtype):
    """Full-width, full-depth Qwen1.5-4B: the full-sequence forward and loss
    through ``get_model(cfg).train_loss`` with K2, computed in ``dtype``
    (the same bf16 weights), every attention on that dtype's route; returns
    K2's launches. The float32 and float16 forwards are profiled once as
    well."""
    cfg = get_config("qwen1.5-4b")
    bundle = get_model(cfg)
    bf16 = dtype == torch.bfloat16
    name, counter = FWD_ROUTES[dtype]
    tol = TOLS[dtype]
    run = RunConfig(compute_dtype=str(dtype)[6:], use_pallas=True)
    assert run.seq_len == FWD_S
    gen = torch.Generator(device="cuda").manual_seed(
        {torch.bfloat16: 2, torch.float32: 3, torch.float16: 4}[dtype])
    toks = torch.randint(0, cfg.vocab_size, (FWD_B, FWD_S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    checked = {"layer": 0, "err": []}

    def checked_flash(q, k, v, **kw):
        """K2 as the forward calls it, held at the first and the last layer
        against the plain version on the same inputs."""
        out = fa_ops.flash_attention(q, k, v, **kw)
        if checked["layer"] in (0, cfg.n_layers - 1):
            checked["err"].append(_assert_close(
                f"{name} forward layer {checked['layer']} attention vs "
                f"plain", out, attention_ref(q, k, v, **kw), tol))
        checked["layer"] += 1
        return out

    _zero_counts()
    wall, n_fwd, prof = [], 0, None
    with torch.no_grad():
        for i in range(1 + FWD_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = bundle.train_loss(params, run, batch)
            torch.cuda.synchronize()
            if i:
                wall.append(time.perf_counter() - t0)
            n_fwd += 1
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"{name} forward {i}: loss "
                                     f"{float(loss)}")
        peak = torch.cuda.max_memory_allocated()
        if not bf16:
            prof = _profile_once(lambda: bundle.train_loss(params, run,
                                                           batch))
            n_fwd += 1
        logits, _ = lm.forward_train(params, cfg, run, batch,
                                     flash=checked_flash)
        n_fwd += 1
        launches = fa_ops.flash_attention.launches
        on_route = (getattr(fa_ops.flash_attention, counter) if counter
                    else launches - fa_ops.flash_attention.launches_bf16
                    - fa_ops.flash_attention.launches_f16)
        if ops.paged_attention.launches:
            raise AssertionError(f"the {name} forward launched "
                                 f"paged_attention")
        loss_k = softmax_xent(logits, batch["labels"])
        plain, _ = lm.forward_train(params, cfg,
                                    run.replace(use_pallas=False), batch)
        loss_p = softmax_xent(plain, batch["labels"])
        # 40 layers of random weights: as in the serve check, the rtol is
        # taken of the logits' largest magnitude
        err_logits = _assert_close(f"{name} forward logits vs plain "
                                   f"attention", logits, plain, tol,
                                   rtol_of_max=True)
        max_logit = float(plain.abs().max())
        del logits, plain
        err_loss = _assert_close(f"{name} forward loss vs plain attention",
                                 loss_k, loss_p, tol)
    if launches != cfg.n_layers * n_fwd or on_route != launches:
        raise AssertionError(f"{name} forward: flash_attention launches "
                             f"{launches} ({name} route {on_route}) != "
                             f"{cfg.n_layers} x {n_fwd} forwards, all on the "
                             f"{name} route")
    if len(checked["err"]) != 2:
        raise AssertionError(f"the layer checks of the {name} forward never "
                             f"ran")
    fwd_ms = 1e3 * statistics.median(wall)
    prof_s = "" if prof is None else (
        f"; profiled forward+loss: {prof['kernels']} kernels, device "
        f"{prof['device_ms']:.1f} of {prof['wall_ms_profiled']:.1f} ms "
        f"(K2 {prof['k2_device_ms']:.1f}, GEMMs {prof['gemm_device_ms']:.1f}, "
        f"other {prof['other_device_ms']:.1f}), idle "
        f"{prof['device_idle_share']:.3f}")
    print(f"[forward] {cfg.name} B={FWD_B} S={FWD_S} {name} use_pallas: "
          f"{n_fwd} forwards, flash_attention launches {launches} "
          f"({launches // n_fwd} per forward; {name} route {on_route}); "
          f"loss {float(loss):.6f} (plain attention {float(loss_p):.6f}, "
          f"|err| {err_loss:.3e}); logits vs plain attention max|err| "
          f"{err_logits:.3e} (max |logit| {max_logit:.3f}); K2 vs plain at "
          f"layers 0 and {cfg.n_layers - 1} max|err| "
          f"{max(checked['err']):.3e}; median forward+loss {fwd_ms:.3f} ms "
          f"({', '.join(f'{1e3 * t:.3f}' for t in wall)}), "
          f"{FWD_B * FWD_S / (fwd_ms / 1e3):.1f} scored tokens/s, K2 share "
          f"{cfg.n_layers * flash_ms / fwd_ms:.3f} ({cfg.n_layers} x "
          f"{flash_ms:.4f} ms); peak memory {peak / 2**30:.1f} GiB{prof_s}")
    if prof is not None:
        print(json.dumps({f"forward_{name}_profile": prof}))
    return launches


def phase_kernel_bench():
    """benchmarks_torch/kernel_bench.py's main, K3's main path and K2's f32
    route's; returns the launches of each kernel in it."""
    counters = (ops.paged_attention, fa_ops.flash_attention,
                ml_ops.mlstm_scan)
    _zero_counts()
    t0 = time.perf_counter()
    kernel_bench.main([])
    launches = {fn.__name__: fn.launches for fn in counters}
    if not all(launches.values()):
        raise AssertionError(f"kernel bench: a kernel never ran {launches}")
    n_bf16 = fa_ops.flash_attention.launches_bf16
    if n_bf16:
        raise AssertionError(f"kernel bench: {n_bf16} f32 flash_attention "
                             f"calls took the bf16 route")
    print(f"[kernel_bench] launches {json.dumps(launches)}, "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_xlstm():
    """Full-width, full-depth xLSTM-125m: forward and loss, prefill and
    greedy decode through ``get_model(cfg)``; K3 on layer 1's own inputs.
    Returns K3's launches on the model path (the model keeps its own chunk
    scan, as the reference does, so 0)."""
    cfg = get_config("xlstm-125m")
    bundle = get_model(cfg)
    run = RunConfig(compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = bundle.init(gen)        # float32 weights, the reference's default
    n_params = sum(t.numel() for t in _leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (XLSTM_B, XLSTM_S + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    wall = []
    with torch.no_grad():
        for i in range(1 + XLSTM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = bundle.train_loss(params, run, batch)
            torch.cuda.synchronize()
            if i:
                wall.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"xlstm forward {i}: loss {float(loss)}")
        peak = torch.cuda.max_memory_allocated()
        if abs(float(loss) - math.log(cfg.vocab_size)) > 1.0:
            raise AssertionError(f"xlstm loss {float(loss)} is not near "
                                 f"ln V = {math.log(cfg.vocab_size):.3f}")
        prompt = batch["tokens"][:, :-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache, lens = bundle.prefill(params, run, None, prompt)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        gen_toks, step_ms, first = [lg.argmax(-1)], [], None
        for _ in range(XLSTM_DECODE):
            t0 = time.perf_counter()
            lg, cache = bundle.decode_step(params, run, cache, gen_toks[-1],
                                           lens)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError("xlstm decode: non-finite logits")
            first = lg if first is None else first
            lens = lens + 1
            gen_toks.append(lg.argmax(-1))
        model_launches = {fn.__name__: fn.launches for fn in
                          (ops.paged_attention, fa_ops.flash_attention,
                           ml_ops.mlstm_scan)}
        if any(model_launches.values()):
            raise AssertionError(f"the xlstm path launched {model_launches}")
        # the forward over the prompt and the first greedy token: its last
        # position is what the first decode step computed. bf16 through 12
        # layers, the chunk scan against the decode cell: the rtol is taken
        # of the logits' largest magnitude, as in the Qwen checks.
        seq = torch.cat([prompt, gen_toks[0][:, None]], dim=1)
        full, _ = xlstm.forward_train(params, cfg, run, {"tokens": seq})
        err_dec = _assert_close("xlstm first decode vs the forward", first,
                                full[:, -1], BF16_TOL, rtol_of_max=True)
        del full
        # K3 on the q, k, v and gates that layer 1 (the first mLSTM block)
        # computes, against the layer's own chunk scan (chunk 256)
        p1 = params["blocks"][1]
        x1, _ = xlstm.slstm_block(params["blocks"][0], cfg,
                                  xlstm._embed(params, run, batch["tokens"]))
        q, k, v, lf, li, _, _ = xlstm._mlstm_qkvg(
            p1, cfg, rms_norm(x1, p1["ln"], cfg.norm_eps))
        q, k, v = q.float(), k.float(), v.float()
        B, H, S, dh = q.shape
        f32 = dict(dtype=torch.float32, device="cuda")
        want, _ = xlstm.mlstm_chunk_scan(
            q, k, v, lf, li, (torch.zeros((B, H, dh, dh), **f32),
                              torch.zeros((B, H, dh), **f32),
                              torch.full((B, H), xlstm.MMIN, **f32)))
        err_layer, form = _scan_close(
            "xlstm layer 1 K3 vs its chunk scan", (q, k, v, lf, li),
            XLSTM_CHUNK, ml_ops.mlstm_scan(q, k, v, lf, li,
                                           chunk=XLSTM_CHUNK), want)
    fwd_ms = 1e3 * statistics.median(wall)
    ntok = XLSTM_B * XLSTM_S
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params (float32), bf16 compute, "
          f"B={XLSTM_B} "
          f"S={XLSTM_S}: loss {float(loss):.6f} (ln V "
          f"{math.log(cfg.vocab_size):.6f}); median forward+loss "
          f"{fwd_ms:.3f} ms ({', '.join(f'{1e3 * t:.3f}' for t in wall)}), "
          f"{ntok / (fwd_ms / 1e3):.1f} scored tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; prefill {XLSTM_S - 1} tokens "
          f"{prefill_ms:.1f} ms; {XLSTM_DECODE} greedy decode steps, median "
          f"{statistics.median(step_ms):.3f} ms; first decode vs forward "
          f"max|err| {err_dec:.3e}; kernel launches on the model path "
          f"{json.dumps(model_launches)}; K3 at layer 1 (chunk "
          f"{XLSTM_CHUNK}) vs the layer's chunk scan max|err| "
          f"{err_layer:.3e} ({form})")
    return model_launches["mlstm_scan"]


# the training phase: the reduced models card against CPU, then the
# reference launcher's xLSTM-125m run and Qwen1.5-4B at full width
TRAIN_DEVICE = "cuda"
TRAIN_SMALL = (("xlstm-125m", 5), ("qwen1.5-4b", 2))
# the MoE (its loss adds 0.01 * aux) and hybrid families: three plain steps
TRAIN_SMALL_FAMILIES = (("moonshot-v1-16b-a3b", 2), ("hymba-1.5b", 2))
TRAIN_SMALL_B, TRAIN_SMALL_S, TRAIN_SMALL_LR = 4, 64, 1e-3
TRAIN_XLSTM_ARGS = ["--arch", "xlstm-125m", "--steps", "8", "--seq", "512",
                    "--batch", "8", "--lr", "3e-4", "--ckpt-every", "4"]
TRAIN_QWEN_LAYERS, TRAIN_QWEN_B, TRAIN_QWEN_S, TRAIN_QWEN_STEPS = 8, 1, 2048, 4


def _train_tree_close(name, got, want, atol, *, strays=False,
                      stray_atol=None):
    """Every leaf of ``got`` (a tree on any device) against ``want`` (on the
    CPU) elementwise at (atol, rtol 2e-4); with ``strays`` at most
    max(2, 0.1%) of a leaf's elements may lie outside, and with
    ``stray_atol`` those within (stray_atol, rtol 2e-4). Returns the largest
    |err| over the elements inside and over the strays."""
    worst, worst_stray = 0.0, 0.0
    for (k, w), g in zip(tree_lib.flatten_with_path(want),
                         tree_lib.leaves(got)):
        w = w.float()
        err = (g.detach().cpu().float() - w).abs()
        off = err > atol + F32_TOL["rtol"] * w.abs()
        n_off = int(off.sum())
        far = (stray_atol is not None and bool(
            (err > stray_atol + F32_TOL["rtol"] * w.abs()).any()))
        if n_off > (max(2, w.numel() // 1000) if strays else 0) or far:
            raise AssertionError(f"{name} {k}: {n_off} of {w.numel()} "
                                 f"elements off, max |err| "
                                 f"{float(err.max()):.3e}")
        if err.numel():
            worst = max(worst, float(err.masked_fill(off, 0).max()))
            worst_stray = max(worst_stray, float(err.max()))
    return worst, worst_stray


def _train_small_case(cfg, run, steps):
    """``steps`` train steps on the card and on the CPU from one set of
    weights and batches; returns {device: (metrics, params, opt, err)}."""
    shape = ShapeConfig("train", "train", TRAIN_SMALL_S, TRAIN_SMALL_B)
    fn = train_steps.build_train_step(cfg, run, shape)
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batches = []
    for _ in steps:
        toks = torch.randint(0, cfg.vocab_size,
                             (TRAIN_SMALL_B, TRAIN_SMALL_S + 1), generator=gen)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    out = {}
    for dev in (TRAIN_DEVICE, "cpu"):
        p = tree_lib.tree_map(lambda t: t.to(dev, copy=True), params)
        opt = adamw.init(p)
        err = (tree_lib.tree_map(torch.zeros_like, p)
               if run.grad_compression == "topk"
               else torch.zeros((), device=dev))
        mets = []
        for s, b in zip(steps, batches):
            p, opt, err, m = fn(p, opt, err, _tree_to(b, dev), s)
            mets.append({k: float(v) for k, v in m.items()})
        out[dev] = (mets, p, opt, err)
    return out


def _train_small():
    """(a) Reduced xLSTM (5 layers) and Qwen (2 layers), f32: three train
    steps on the card against the CPU, then one microbatched and one top-k
    step; reduced moonshot (its loss with the MoE aux term) and hymba (2
    layers each): three steps; losses, grad norms, lr, every parameter,
    moment and error-feedback leaf."""
    base = RunConfig(compute_dtype="float32", remat="none", lr=TRAIN_SMALL_LR,
                     warmup_steps=1, total_steps=10)
    cases = []
    for arch, n_layers in TRAIN_SMALL:
        cfg = reduced(get_config(arch), n_layers=n_layers)
        cases += [(f"{arch} {n_layers}L", cfg, base, (0, 1, 2)),
                  (f"{arch} {n_layers}L microbatch 2", cfg,
                   base.replace(microbatch=2), (1,)),
                  (f"{arch} {n_layers}L top-k 0.2", cfg,
                   base.replace(grad_compression="topk", topk_ratio=0.2),
                   (1,))]
    for arch, n_layers in TRAIN_SMALL_FAMILIES:
        cases.append((f"{arch} {n_layers}L",
                      reduced(get_config(arch), n_layers=n_layers), base,
                      (0, 1, 2)))
    recs = []
    for name, cfg, run, steps in cases:
        out = _train_small_case(cfg, run, steps)
        (mc, pc, oc, ec), (mh, ph, oh, eh) = out[TRAIN_DEVICE], out["cpu"]
        topk = run.grad_compression == "topk"
        for s, a, b in zip(steps, mc, mh):
            for k in a:
                if abs(a[k] - b[k]) > F32_TOL["atol"] + \
                        F32_TOL["rtol"] * abs(b[k]):
                    raise AssertionError(f"train small {name} step {s} {k}: "
                                         f"card {a[k]} cpu {b[k]}")
        updates = sum(m["lr"] > 0 for m in mh)
        p_atol = F32_TOL["atol"] + 0.1 * run.lr * updates
        p_err, p_stray = _train_tree_close(
            name + " params", pc, ph, p_atol, strays=True,
            stray_atol=F32_TOL["atol"] + 2 * run.lr * updates)
        m_err = max(_train_tree_close(name + " " + k, getattr(oc, k),
                                      getattr(oh, k), F32_TOL["atol"],
                                      strays=topk)[0] for k in ("mu", "nu"))
        rec = {"case": name, "steps": list(steps),
               "loss": [m["loss"] for m in mc],
               "loss_cpu": [m["loss"] for m in mh],
               "grad_norm": [m["grad_norm"] for m in mc],
               "params_max_abs_err": p_err, "params_atol": p_atol,
               "params_max_abs_err_strays": p_stray,
               "moments_max_abs_err": m_err}
        if topk:
            rec["err_max_abs_err"] = _train_tree_close(
                name + " err", ec, eh, F32_TOL["atol"], strays=True)[0]
        recs.append(rec)
        print(f"[train] small {name}: steps {list(steps)}, card loss "
              f"{rec['loss']} (cpu {rec['loss_cpu']}), grad norm "
              f"{rec['grad_norm']}; params max|err| {p_err:.3e} (atol "
              f"{p_atol:.1e}; with the strays {p_stray:.3e}), moments "
              f"{m_err:.3e}" + (f", error feedback {rec['err_max_abs_err']:.3e}"
                                if topk else ""))
    print("[train] small: parameters are held at atol 2e-5 + 0.1 lr per "
          "update, but for at most max(2, 0.1%) elements of a leaf, held at "
          "2e-5 + 2 lr per update: AdamW normalises each element's step "
          "(lr m_hat / (sqrt(v_hat) + eps)), so an element whose gradient "
          "sits at float32 rounding or near eps moves by a share of lr, up to "
          "2 lr, that the two devices' last bits decide; the moments meet "
          "the f32 bar. Top-k: at most max(2, 0.1%) elements of a leaf, "
          "those at the k-th magnitude, may be sent on one device and kept "
          "on the other.")
    return recs


def _train_profile(trainer, state):
    """One train step under a torch.profiler window (``_profile_once``):
    kernels and copies per step, device busy ms, wall ms, idle share."""
    out = []
    prof = _profile_once(lambda: out.append(trainer.train(1, state=state)))
    return out[0], {"kernels_per_step": prof["kernels"],
                    "copies_per_step": prof["copies"],
                    "device_ms": prof["device_ms"],
                    "wall_ms_profiled": prof["wall_ms_profiled"],
                    "device_idle_share": prof["device_idle_share"]}


def _steps_summary(trainer, tokens):
    times = trainer.step_times[1:]            # the first step warms up
    ms = 1e3 * statistics.median(times)
    return {"step_ms_median": ms,
            "step_ms": [1e3 * t for t in trainer.step_times],
            "tokens_per_s": tokens / (ms / 1e3)}


def _train_xlstm(tmp):
    """(b) The reference launcher's xLSTM-125m run through
    ``launch/train.py`` (12 layers, B=8, S=512, f32, remat none, lr 3e-4):
    8 steps with a checkpoint every 4, then a second Trainer restored from
    step 4 runs steps 5-8; its state must equal the continuous run's."""
    d1, d2 = os.path.join(tmp, "run"), os.path.join(tmp, "resume")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr, st = launch_train.main(TRAIN_XLSTM_ARGS + ["--ckpt", d1,
                                                   "--device", TRAIN_DEVICE])
    peak = torch.cuda.max_memory_allocated()
    cfg, shape = tr.cfg, tr.shape
    n_params = sum(t.numel() for t in tree_lib.leaves(st.params))
    losses = [m["loss"] for m in tr.metrics_log]
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - ln_v) > 0.5 or not losses[-1] < losses[0]:
        raise AssertionError(f"train xlstm: losses {losses} (ln V {ln_v:.3f})")
    summary = _steps_summary(tr, shape.tokens)
    shutil.copytree(os.path.join(d1, "step_00000004"),
                    os.path.join(d2, "step_00000004"))
    tr2 = launch_train.make_trainer(launch_train.parse_args(
        TRAIN_XLSTM_ARGS + ["--ckpt", d2, "--device", TRAIN_DEVICE]))
    st2 = tr2.train(4)
    if tr2.events[:1] != ["restored step 4"] or st2.step != 8:
        raise AssertionError(f"train xlstm resume: {tr2.events}, step "
                             f"{st2.step}")
    resumed = [m["loss"] for m in tr2.metrics_log]
    same = resumed == losses[4:] and all(
        torch.equal(a, b) for a, b in zip(tree_lib.leaves((st.params, st.opt)),
                                          tree_lib.leaves((st2.params,
                                                           st2.opt))))
    resume_err = 0.0
    if not same:
        resume_err = _train_tree_close(
            "train xlstm resume params", st2.params,
            tree_lib.tree_map(lambda t: t.cpu(), st.params),
            F32_TOL["atol"] + 0.1 * 3e-4 * 4, strays=True,
            stray_atol=F32_TOL["atol"] + 2 * 3e-4 * 4)[1]
        print("[train] xlstm: the resumed run is not bit-identical to the "
              "continuous one (an operation on the path reduces in no fixed "
              "order); held at the small cases' parameter rule")
    del st, tr
    _, prof = _train_profile(tr2, st2)
    rec = {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params,
           "batch": shape.global_batch, "seq": shape.seq_len,
           "dtype": "float32", "remat": "none", "losses": losses,
           "resumed_losses": resumed, "resume_bit_identical": same,
           "resume_max_abs_err": resume_err,
           "peak_memory_gib": peak / 2**30, **summary, **prof}
    print(f"[train] xlstm: {cfg.name} {cfg.n_layers} layers d {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params f32, B={shape.global_batch} "
          f"S={shape.seq_len}: losses {[round(x, 4) for x in losses]} (ln V "
          f"{ln_v:.4f}); median step {summary['step_ms_median']:.1f} ms, "
          f"{summary['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; resumed from step 4: "
          f"{'bit-identical' if same else 'max|err| %.3e' % resume_err}; "
          f"profiled step: {prof['kernels_per_step']} kernels, "
          f"{prof['copies_per_step']} copies, device {prof['device_ms']:.1f} "
          f"of {prof['wall_ms_profiled']:.1f} ms, idle "
          f"{prof['device_idle_share']:.3f}")
    return rec


def _train_qwen():
    """(c) Qwen1.5-4B at full width, 8 of its 40 layers (f32 AdamW state at
    all 40 is 63 GB before activations): B=1, S=2048, f32, remat full,
    4 steps through ``Trainer``; then a step with use_pallas must raise."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b"),
                              n_layers=TRAIN_QWEN_LAYERS)
    run = RunConfig(seq_len=TRAIN_QWEN_S, global_batch=TRAIN_QWEN_B, lr=3e-4,
                    warmup_steps=1, total_steps=TRAIN_QWEN_STEPS,
                    compute_dtype="float32", remat="full")
    shape = ShapeConfig("train", "train", TRAIN_QWEN_S, TRAIN_QWEN_B)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, run, shape, device=TRAIN_DEVICE)
    st = tr.train(TRAIN_QWEN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_lib.leaves(st.params))
    losses = [m["loss"] for m in tr.metrics_log]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train qwen: losses {losses}")
    summary = _steps_summary(tr, shape.tokens)
    tflops = 6 * n_params * shape.tokens / (summary["step_ms_median"] / 1e3)
    st, prof = _train_profile(tr, st)
    refused = None
    try:
        Trainer(cfg, run.replace(use_pallas=True), shape,
                device=TRAIN_DEVICE).train(1, state=st)
    except RuntimeError as e:
        refused = str(e)
    if not refused or "no backward" not in refused:
        raise AssertionError(f"train qwen: a use_pallas step did not raise "
                             f"the kernel's refusal ({refused!r})")
    rec = {"config": f"{cfg.name} ({cfg.n_layers} of 40 layers)",
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params,
           "batch": shape.global_batch, "seq": shape.seq_len,
           "dtype": "float32", "remat": "full", "losses": losses,
           "peak_memory_gib": peak / 2**30, **summary,
           "model_tflops_per_s": tflops / 1e12,
           "f32_peak_tflops_per_s": F32_FLOPS_PER_S / 1e12,
           "use_pallas_step": refused, **prof}
    print(f"[train] qwen: {rec['config']}, {n_params / 1e9:.3f} B params "
          f"f32, B={shape.global_batch} S={shape.seq_len}, remat full: losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{summary['step_ms_median']:.1f} ms, {summary['tokens_per_s']:.1f} "
          f"tokens/s, {tflops / 1e12:.2f} TFLOP/s (6 N tokens per step; f32 "
          f"peak {F32_FLOPS_PER_S / 1e12:.0f}), peak memory "
          f"{peak / 2**30:.2f} GiB; profiled step: "
          f"{prof['kernels_per_step']} kernels, device "
          f"{prof['device_ms']:.1f} of {prof['wall_ms_profiled']:.1f} ms, "
          f"idle {prof['device_idle_share']:.3f}; use_pallas step raised: "
          f"{refused}")
    return rec


def phase_train():
    """The training path (no kernel on it: K1-K3 launch 0 times)."""
    t0 = time.perf_counter()
    _zero_counts()
    small = _train_small()
    with tempfile.TemporaryDirectory() as tmp:
        xl = _train_xlstm(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    qw = _train_qwen()
    launches = {fn.__name__: fn.launches for fn in
                (ops.paged_attention, fa_ops.flash_attention,
                 ml_ops.mlstm_scan)}
    if any(launches.values()):
        raise AssertionError(f"the training path launched {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"small": small, "xlstm_125m": xl, "qwen1_5_4b_8_layers": qw,
           "kernel_launches": launches,
           "phase_s": time.perf_counter() - t0}
    print(json.dumps({"train": rec}))
    return launches


# the model families phase (slice M): the reduced configs card against
# CPU, then moonshot (MoE, K2 in every layer), hymba and whisper at full width
FAM_SMALL = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "hymba-1.5b",
             "whisper-large-v3")
FAM_SMALL_B, FAM_SMALL_S, FAM_SMALL_DECODE = 2, 64, 4
FAM_MOE_B, FAM_MOE_S = 1, 4096
FAM_HYMBA_B, FAM_HYMBA_S = 2, 4096
FAM_WHISPER_B, FAM_WHISPER_S = 2, 448    # whisper's longest decoder input
FAM_TIMED, FAM_DECODE = 3, 8
FAM_TIE = 1e-2     # router-logit gap below which an expert choice may flip
_FAM_LIB = {"moe": lm, "hybrid": hymba, "audio": whisper}


def _fam_batch(cfg, B, S, gen, device, dtype=torch.float32):
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(
            B, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=device).to(dtype)
    return batch


def _fam_greedy(bundle, params, run, batch, n_prompt, n_decode, dtype):
    """``prefill`` of the first ``n_prompt`` tokens, then ``n_decode``
    greedy ``decode_step``s. Returns (tokens (B, 1 + n_decode), prefill ms,
    decode ms per step)."""
    toks = batch["tokens"][:, :n_prompt]
    B, dev = toks.shape[0], toks.device
    extra = ({"audio_embeds": batch["audio_embeds"]}
             if "audio_embeds" in batch else None)
    cache = bundle.init_cache(B, n_prompt + n_decode, dtype, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache, lens = bundle.prefill(params, run, cache, toks, extra=extra)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    out, step_ms = [lg.argmax(-1)], []
    for _ in range(n_decode):
        t0 = time.perf_counter()
        lg, cache = bundle.decode_step(params, run, cache, out[-1], lens)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{bundle.cfg.name} decode: non-finite "
                                 f"logits")
        lens = lens + 1
        out.append(lg.argmax(-1))
    return torch.stack(out, 1), prefill_ms, step_ms


def _logits_close_f32(name, got, want):
    """The f32 bar with its atol taken times the largest |logit|
    (tests/test_torch_hymba.py's rule for logits)."""
    scale = max(1.0, float(want.float().abs().max()))
    return _assert_close(name, got, want,
                         dict(atol=F32_TOL["atol"] * scale,
                              rtol=F32_TOL["rtol"]))


def _fam_small():
    """The reduced configs (llama4-scout's top-1 routing beside moonshot's),
    f32, card against CPU from one set of weights: the logits, aux and loss
    with use_pallas (K2's f32 route on the card: the MoE self-attention,
    whisper's encoder at 64 frames and its decoder's self- and
    cross-attention; hymba none), then prefill and 4 greedy decode steps.
    Returns K2's launches on the card."""
    run = RunConfig(compute_dtype="float32", use_pallas=True)
    total = 0
    for arch in FAM_SMALL:
        cfg = reduced(get_config(arch))
        bundle, lib = get_model(cfg), _FAM_LIB[cfg.family]
        params = bundle.init(torch.Generator().manual_seed(0))
        batch = _fam_batch(cfg, FAM_SMALL_B, FAM_SMALL_S,
                           torch.Generator().manual_seed(1), "cpu")
        # per forward (twice: the logits, the loss), and whisper's encoder
        # once more at prefill
        per_fwd = {"moe": cfg.n_layers, "hybrid": 0,
                   "audio": 2 * cfg.n_layers + cfg.n_encoder_layers}
        want = 2 * per_fwd[cfg.family] + (cfg.n_encoder_layers
                                          if cfg.family == "audio" else 0)
        out = {}
        for dev in ("cpu", "cuda"):
            p, b = _tree_to(params, dev), _tree_to(batch, dev)
            before = fa_ops.flash_attention.launches
            with torch.no_grad():
                logits, aux = lib.forward_train(p, cfg, run, b)
                loss = bundle.train_loss(p, run, b)
                toks, _, _ = _fam_greedy(bundle, p, run, b, FAM_SMALL_S - 8,
                                         FAM_SMALL_DECODE, torch.float32)
            launched = fa_ops.flash_attention.launches - before
            out[dev] = (logits.cpu(), aux.cpu(), loss.cpu(), toks.cpu())
            if launched != (want if dev == "cuda" else 0):
                raise AssertionError(f"families small {arch} on {dev}: K2 "
                                     f"launched {launched}, want "
                                     f"{want if dev == 'cuda' else 0}")
            total += launched
        (lc, ac, sc, tc), (lh, ah, sh, th) = out["cuda"], out["cpu"]
        err = _logits_close_f32(f"families small {arch} logits", lc, lh)
        _assert_close(f"families small {arch} aux", ac, ah, F32_TOL)
        err_l = _assert_close(f"families small {arch} loss", sc, sh, F32_TOL)
        if not torch.equal(tc, th):
            raise AssertionError(f"families small {arch}: card tokens {tc} "
                                 f"!= cpu tokens {th}")
        print(f"[families] small {cfg.name} ({cfg.family}, "
              f"{cfg.n_layers} layers" +
              (f", {cfg.n_experts} experts top-{cfg.top_k}"
               if cfg.family == "moe" else "") +
              f") B={FAM_SMALL_B} S={FAM_SMALL_S} f32 use_pallas: logits "
              f"max|err| {err:.3e}, aux {float(ac):.6f}, loss "
              f"{float(sc):.6f} (|err| {err_l:.3e}); K2 launches "
              f"{want} on the card (f32 route); prefill "
              f"{FAM_SMALL_S - 8} + {FAM_SMALL_DECODE} greedy decode steps: "
              f"card tokens == cpu tokens {tc.tolist()}")
    return total


def _profile_once(fn):
    """``fn()`` under a torch.profiler window (device activity): kernels,
    copies, device busy ms (K2's and the GEMMs' apart, the five kernels
    that take most), wall ms, idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(e.name.lower().startswith(("memcpy", "memset"))
                 for e in dev)
    busy = sum(e.device_time_total for e in dev)
    k2 = sum(e.device_time_total for e in dev if "flash" in e.name.lower())
    gemm = sum(e.device_time_total for e in dev
               if re.search(r"gemm|xmma|cutlass|nvjet|wgmma", e.name.lower())
               and "flash" not in e.name.lower())
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels": len(dev) - copies, "copies": copies,
            "top_kernels_ms": {n[:80]: t / 1e3 for n, t in top},
            "device_ms": busy / 1e3, "k2_device_ms": k2 / 1e3,
            "gemm_device_ms": gemm / 1e3,
            "other_device_ms": (busy - k2 - gemm) / 1e3,
            "wall_ms_profiled": 1e3 * wall,
            "device_idle_share": 1.0 - busy / (1e6 * wall)}


def _fam_timed(fn, name):
    """One warm-up and FAM_TIMED timed calls of ``fn()`` (a loss), each
    synchronized; returns (last loss, wall seconds of the timed ones)."""
    wall = []
    for i in range(1 + FAM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn()
        torch.cuda.synchronize()
        if i:
            wall.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"{name} forward {i}: loss {float(loss)}")
    return loss, wall


def _fam_init(arch):
    cfg = get_config(arch)
    bundle = get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device="cuda").manual_seed(4),
                         torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_lib.leaves(params))
    return cfg, bundle, params, n, time.perf_counter() - t0


def _fam_summary(cfg, n_params, init_s, B, S, wall, peak, prefill_ms,
                 step_ms, prof=None):
    ms = 1e3 * statistics.median(wall)
    rec = {"config": cfg.name, "params": n_params, "init_s": init_s,
           "batch": B, "seq": S, "forward_loss_ms_median": ms,
           "forward_loss_ms": [1e3 * t for t in wall],
           "scored_tokens_per_s": B * S / (ms / 1e3),
           "peak_memory_gib": peak / 2**30, "prefill_ms": prefill_ms,
           "decode_ms_median": statistics.median(step_ms),
           "decode_ms": step_ms}
    if prof:
        rec["profile_one_forward"] = prof
    return rec


def _fam_moonshot():
    """moonshot-v1-16b-a3b at full width and depth, bf16: train_loss with
    use_pallas (K2 once per layer, the bf16 route); K2 against its plain
    version on every layer's own q, k, v; every block with the plain
    attention on the kernel forward's own input and expert choices; a
    free-running plain-attention forward (loss, layer 0's experts, the
    divergence per layer); a profiled forward; prefill and greedy
    decode."""
    cfg, bundle, params, n_params, init_s = _fam_init("moonshot-v1-16b-a3b")
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = _fam_batch(cfg, FAM_MOE_B, FAM_MOE_S, gen, "cuda")
    run = RunConfig(compute_dtype="bfloat16", use_pallas=True)
    plain_run = run.replace(use_pallas=False)
    # Random weights make the residual stream grow through the 48 layers
    # (rms ~30 after layer 0, ~320 after layer 47) and amplify any bf16
    # rounding difference: two attentions that differ only in rounding
    # drift apart by ~0.3% of the stream per layer, so the free-running
    # logits meet no bf16 bar. And top-k routing is discontinuous: a near
    # tie flips. So each block is checked on the kernel forward's own
    # input and expert choices (layer-local), and the free-running forward
    # is held at the loss and reported layer by layer.
    real_route, real_block = moe_lib._route, lm.apply_block
    tr = {"mode": None, "i": 0, "x": [], "y": [], "idx": [], "flips": [],
          "block_err": [], "drift": [], "layer0": None, "k2_err": []}

    def route(x, router, c):
        if tr["mode"] != "replay":
            out = real_route(x, router, c)
            if tr["mode"] == "record":
                tr["idx"].append(out[0])
            elif tr["layer0"] is None:
                tr["layer0"] = (out[0], x.float() @ router.float())
            return out
        logits = x.float() @ router.float()
        gates_all = torch.softmax(logits, dim=-1)
        own = gates_all.topk(c.top_k, dim=-1).indices
        idx = tr["idx"][tr["i"]]
        tr["flips"].append(int((own.sort(-1).values
                                != idx.sort(-1).values).any(-1).sum()))
        gate = gates_all.gather(-1, idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        ce = torch.bincount(idx.reshape(-1), minlength=c.n_experts).float() \
            * (1.0 / idx.numel())
        aux = c.n_experts * (gates_all.mean(0) * ce).sum() \
            + 1e-4 * torch.logsumexp(logits, dim=-1).square().mean()
        return idx, gate, aux

    def block(p, c, r, x, **kw):
        if tr["mode"] == "replay":
            x = tr["x"][tr["i"]]
        out = real_block(p, c, r, x, **kw)
        if tr["mode"] == "record":
            tr["x"].append(x)
            tr["y"].append(out[0])
        elif tr["mode"] == "replay":
            tr["block_err"].append(_assert_close(
                f"moonshot block {tr['i']} plain vs K2 on its input",
                out[0], tr["y"][tr["i"]], BF16_TOL, rtol_of_max=True))
            tr["i"] += 1
        else:
            want = tr["y"][len(tr["drift"])].float()
            tr["drift"].append(float((out[0].float() - want).norm()
                                     / want.norm()))
        return out

    def checked_flash(q, k, v, **kw):
        out = fa_ops.flash_attention(q, k, v, **kw)
        tr["k2_err"].append(_assert_close(
            f"moonshot layer {len(tr['k2_err'])} K2 vs plain", out,
            attention_ref(q, k, v, **kw), BF16_TOL))
        return out

    _zero_counts()
    with torch.no_grad():
        loss, wall = _fam_timed(lambda: bundle.train_loss(params, run, batch),
                                cfg.name)
        moe_lib._route, lm.apply_block = route, block
        try:
            tr["mode"] = "record"
            logits, aux = lm.forward_train(params, cfg, run, batch,
                                           flash=checked_flash)
            n_fwd = 2 + FAM_TIMED
            launches = fa_ops.flash_attention.launches
            launches_bf16 = fa_ops.flash_attention.launches_bf16
            peak = torch.cuda.max_memory_allocated()
            loss_k = softmax_xent(logits, batch["labels"]) + 0.01 * aux
            tr["mode"] = "replay"
            local, _ = lm.forward_train(params, cfg, plain_run, batch)
            err_logits = _assert_close(
                "moonshot logits, last block plain vs K2 on its input",
                local, logits, BF16_TOL, rtol_of_max=True)
            del local, logits
            tr["mode"] = "free"
            plain, aux_p = lm.forward_train(params, cfg, plain_run, batch)
        finally:
            moe_lib._route, lm.apply_block = real_route, real_block
        loss_p = softmax_xent(plain, batch["labels"]) + 0.01 * aux_p
        del plain
        tr["x"], tr["y"] = [], []
        err_loss = _assert_close("moonshot loss vs plain attention", loss_k,
                                 loss_p, BF16_TOL)
        idx_k, (idx_p, lg_p) = tr["idx"][0], tr["layer0"]
        top = lg_p.topk(cfg.top_k + 1, dim=-1).values
        gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        same = (idx_k.sort(-1).values == idx_p.sort(-1).values).all(-1)
        near = gap <= FAM_TIE
        if bool((~same & ~near).any()):
            raise AssertionError(
                f"moonshot layer 0: {int((~same & ~near).sum())} tokens "
                f"with a router gap above {FAM_TIE} chose other experts")
        if len(tr["k2_err"]) != cfg.n_layers or \
                len(tr["block_err"]) != cfg.n_layers:
            raise AssertionError("moonshot: the layer checks did not run")
        flips = tr["flips"]
        if fa_ops.flash_attention.launches != launches:
            raise AssertionError("the plain-attention forward launched K2")
        prof = _profile_once(lambda: bundle.train_loss(params, run, batch))
        if launches != cfg.n_layers * n_fwd or launches_bf16 != launches:
            raise AssertionError(f"moonshot: K2 launches {launches} (bf16 "
                                 f"route {launches_bf16}) != "
                                 f"{cfg.n_layers} x {n_fwd} forwards")
        greedy, prefill_ms, step_ms = _fam_greedy(
            bundle, params, run.replace(use_pallas=False), batch,
            FAM_MOE_S - FAM_DECODE, FAM_DECODE, torch.bfloat16)
    rec = _fam_summary(cfg, n_params, init_s, FAM_MOE_B, FAM_MOE_S, wall,
                       peak, prefill_ms, step_ms, prof)
    rec.update({"k2_launches": launches, "k2_launches_bf16": launches_bf16,
                "k2_per_forward": launches // n_fwd,
                "loss": float(loss), "loss_plain": float(loss_p),
                "aux": float(aux), "logits_max_abs_err": err_logits,
                "loss_abs_err": err_loss,
                "layer0_tokens": int(same.numel()),
                "layer0_same_experts": int(same.sum()),
                "layer0_near_ties": int(near.sum()),
                "layer0_near_ties_differing": int((~same & near).sum()),
                "layer0_min_gap": float(gap.min()),
                "k2_vs_plain_max_abs_err_per_layer": max(tr["k2_err"]),
                "block_vs_plain_max_abs_err": max(tr["block_err"]),
                "replayed_route_flips_per_layer": flips,
                "free_running_drift_per_layer": tr["drift"]})
    print(f"[families] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} + shared, "
          f"{n_params / 1e9:.3f} B params (bf16, init {init_s:.1f} s), "
          f"B={FAM_MOE_B} S={FAM_MOE_S} use_pallas: loss {float(loss):.6f} "
          f"(aux {float(aux):.4f}; a free-running plain-attention forward "
          f"{float(loss_p):.6f}, |err| {err_loss:.3e}); K2 vs plain on each "
          f"layer's q, k, v max|err| {max(tr['k2_err']):.3e}; each block "
          f"with the plain attention on the kernel forward's input and "
          f"experts max|err| {max(tr['block_err']):.3e}, the logits so "
          f"{err_logits:.3e} (bf16, rtol of the largest |value|); free "
          f"running, the stream drifts from the kernel forward's by "
          f"{tr['drift'][0]:.2e} after layer 0, {tr['drift'][-1]:.2e} after "
          f"layer {cfg.n_layers - 1} (relative Frobenius); K2 launches "
          f"{launches} in {n_fwd} forwards "
          f"({launches // n_fwd} per forward, bf16 route {launches_bf16}); "
          f"layer 0 experts equal for {int(same.sum())} of {same.numel()} "
          f"tokens ({int(near.sum())} with a router gap <= {FAM_TIE}, "
          f"{int((~same & near).sum())} of them differing; min gap "
          f"{float(gap.min()):.2e}); on the kernel forward's inputs the "
          f"plain attention would have flipped the experts of "
          f"{sum(flips)} token-layers ({max(flips)} at most in a layer); "
          f"median forward+loss "
          f"{rec['forward_loss_ms_median']:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in rec['forward_loss_ms'])}), "
          f"{rec['scored_tokens_per_s']:.1f} scored tokens/s, peak memory "
          f"{rec['peak_memory_gib']:.2f} GiB; profiled forward: "
          f"{prof['kernels']} kernels, device {prof['device_ms']:.1f} ms "
          f"(K2 {prof['k2_device_ms']:.1f}, GEMM {prof['gemm_device_ms']:.1f},"
          f" other {prof['other_device_ms']:.1f}) of "
          f"{prof['wall_ms_profiled']:.1f} ms, idle "
          f"{prof['device_idle_share']:.3f}; prefill "
          f"{FAM_MOE_S - FAM_DECODE} tokens {prefill_ms:.1f} ms, "
          f"{FAM_DECODE} greedy decode steps, median "
          f"{rec['decode_ms_median']:.2f} ms")
    del params
    return rec


def _fam_hymba():
    """hymba-1.5b at full width and depth, bf16: train_loss with use_pallas
    (K2 never launches: the per-layer windows keep it off, as in the
    reference), a profiled forward, prefill and greedy decode."""
    cfg, bundle, params, n_params, init_s = _fam_init("hymba-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = _fam_batch(cfg, FAM_HYMBA_B, FAM_HYMBA_S, gen, "cuda")
    run = RunConfig(compute_dtype="bfloat16", use_pallas=True)
    _zero_counts()
    with torch.no_grad():
        loss, wall = _fam_timed(lambda: bundle.train_loss(params, run, batch),
                                cfg.name)
        peak = torch.cuda.max_memory_allocated()
        launched = {fn.__name__: fn.launches for fn in
                    (ops.paged_attention, fa_ops.flash_attention,
                     ml_ops.mlstm_scan)}
        if any(launched.values()):
            raise AssertionError(f"hymba launched {launched}")
        prof = _profile_once(lambda: bundle.train_loss(params, run, batch))
        greedy, prefill_ms, step_ms = _fam_greedy(
            bundle, params, run, batch, FAM_HYMBA_S - FAM_DECODE, FAM_DECODE,
            torch.bfloat16)
    rec = _fam_summary(cfg, n_params, init_s, FAM_HYMBA_B, FAM_HYMBA_S, wall,
                       peak, prefill_ms, step_ms, prof)
    rec.update({"loss": float(loss), "k2_launches": 0,
                "windows": sorted(set(lm.layer_windows(cfg).tolist()))})
    print(f"[families] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, windows {rec['windows']} (global every "
          f"{cfg.global_every}), {n_params / 1e9:.3f} B params (bf16), "
          f"B={FAM_HYMBA_B} S={FAM_HYMBA_S} use_pallas: loss "
          f"{float(loss):.6f}; kernel launches {json.dumps(launched)}; "
          f"median forward+loss {rec['forward_loss_ms_median']:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in rec['forward_loss_ms'])}), "
          f"{rec['scored_tokens_per_s']:.1f} scored tokens/s, peak memory "
          f"{rec['peak_memory_gib']:.2f} GiB; profiled forward: "
          f"{prof['kernels']} kernels, device {prof['device_ms']:.1f} ms "
          f"(GEMM {prof['gemm_device_ms']:.1f}, other "
          f"{prof['other_device_ms']:.1f}) of {prof['wall_ms_profiled']:.1f} "
          f"ms, idle {prof['device_idle_share']:.3f}; prefill "
          f"{FAM_HYMBA_S - FAM_DECODE} tokens {prefill_ms:.1f} ms, "
          f"{FAM_DECODE} greedy decode steps, median "
          f"{rec['decode_ms_median']:.2f} ms")
    del params
    return rec


def _fam_whisper():
    """whisper-large-v3 at full width and depth, bf16: 1,500 audio frames
    and 448 decoder tokens without use_pallas (the only setting the
    reference completes there), prefill and greedy decode; then use_pallas
    must raise the reference's block assertion at the first
    cross-attention, after the first decoder self-attention's K2 launch
    and before any other. Returns K2's launches (1)."""
    cfg, bundle, params, n_params, init_s = _fam_init("whisper-large-v3")
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = _fam_batch(cfg, FAM_WHISPER_B, FAM_WHISPER_S, gen, "cuda",
                       torch.bfloat16)
    run = RunConfig(compute_dtype="bfloat16")
    _zero_counts()
    with torch.no_grad():
        loss, wall = _fam_timed(lambda: bundle.train_loss(params, run, batch),
                                cfg.name)
        peak = torch.cuda.max_memory_allocated()
        if fa_ops.flash_attention.launches:
            raise AssertionError("whisper without use_pallas launched K2")
        prof = _profile_once(lambda: bundle.train_loss(params, run, batch))
        greedy, prefill_ms, step_ms = _fam_greedy(
            bundle, params, run, batch, FAM_WHISPER_S - FAM_DECODE,
            FAM_DECODE, torch.bfloat16)
        refused = None
        try:
            bundle.train_loss(params, run.replace(use_pallas=True), batch)
        except AssertionError as e:
            refused = str(e)
    want = (f"seq ({FAM_WHISPER_S},{cfg.encoder_seq}) must divide blocks "
            f"(64,64)")
    launched = fa_ops.flash_attention.launches
    if refused != want or launched != 1 or \
            fa_ops.flash_attention.launches_bf16 != 1:
        raise AssertionError(f"whisper use_pallas: raised {refused!r} after "
                             f"{launched} K2 launches; want {want!r} after 1")
    rec = _fam_summary(cfg, n_params, init_s, FAM_WHISPER_B, FAM_WHISPER_S,
                       wall, peak, prefill_ms, step_ms, prof)
    rec.update({"loss": float(loss), "encoder_frames": cfg.encoder_seq,
                "use_pallas_refusal": refused,
                "k2_launches_before_refusal": launched})
    print(f"[families] {cfg.name}: {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params (bf16), B={FAM_WHISPER_B}, "
          f"{cfg.encoder_seq} frames, {FAM_WHISPER_S} decoder tokens: loss "
          f"{float(loss):.6f}; median forward+loss "
          f"{rec['forward_loss_ms_median']:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in rec['forward_loss_ms'])}), "
          f"{rec['scored_tokens_per_s']:.1f} scored tokens/s, peak memory "
          f"{rec['peak_memory_gib']:.2f} GiB; profiled forward: "
          f"{prof['kernels']} kernels, device {prof['device_ms']:.1f} ms "
          f"(GEMM {prof['gemm_device_ms']:.1f}, other "
          f"{prof['other_device_ms']:.1f}) of {prof['wall_ms_profiled']:.1f} "
          f"ms, idle {prof['device_idle_share']:.3f}; prefill "
          f"{FAM_WHISPER_S - FAM_DECODE} tokens {prefill_ms:.1f} ms, "
          f"{FAM_DECODE} greedy decode steps, median "
          f"{rec['decode_ms_median']:.2f} ms; use_pallas raised "
          f"AssertionError({refused!r}) after {launched} K2 launch (layer "
          f"0's self-attention), before the cross-attention")
    del params
    return rec, launched


def _fam_k2_moe_shape():
    """K2 at moonshot's attention shape (B=1, H=16, S=4096, d=128, bf16,
    causal) against its plain version; one eager call, device time from
    CUDA-graph replays, the plain version, SDPA, the bound."""
    B, H, S, d = FAM_MOE_B, 16, FAM_MOE_S, 128
    x = _flash_inputs(torch.Generator(device="cuda").manual_seed(8), B, H, H,
                      S, S, d, torch.bfloat16)
    err = _assert_close("flash_attention moonshot shape bf16",
                        fa_ops.flash_attention(*x), attention_ref(*x),
                        BF16_TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 4 * B * H * S * d * x[0].element_size()
    n_flops = 4 * B * H * d * S * (S + 1) // 2
    bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)
    rec = {"shape": f"B={B} H={H} S={S} d={d} bf16 causal",
           "max_abs_err": err,
           "ms": _time_ms(lambda: fa_ops.flash_attention(*x), 20),
           "device_ms": _device_ms(lambda: fa_ops.flash_attention(*x)),
           "plain_ms": _time_ms(lambda: attention_ref(*x), 5),
           "library_ms": _time_ms(lambda: sdpa(*x, is_causal=True), 20),
           "library_device_ms": _device_ms(
               lambda: sdpa(*x, is_causal=True)),
           "bound_ms": bound, "bound_by": by}
    print(f"[families] K2 at the moonshot shape {rec['shape']}: "
          f"{rec['ms']:.4f} ms one eager call, {rec['device_ms']:.4f} ms "
          f"device (graph replays), bound {bound:.4f} ms ({by}); plain "
          f"{rec['plain_ms']:.4f} ms; sdpa is_causal {rec['library_ms']:.4f} "
          f"ms eager, {rec['library_device_ms']:.4f} ms device; max|err| "
          f"{err:.3e}")
    return rec


def phase_families():
    """The model families (slice M): the reduced configs card vs CPU, K2 at
    the moonshot shape, then moonshot, hymba and whisper at full width.
    Returns K2's launches on its main paths here, by route, and a
    record."""
    t0 = time.perf_counter()
    _zero_counts()
    n_small = _fam_small()
    k2 = _fam_k2_moe_shape()
    moon = _fam_moonshot()
    hym = _fam_hymba()
    whi, n_whisper = _fam_whisper()
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"small_k2_launches_f32": n_small, "k2_moonshot_shape": k2,
           "moonshot": moon, "hymba": hym, "whisper": whi,
           "phase_s": time.perf_counter() - t0}
    print(json.dumps({"families": rec}))
    print(f"[families] phase {rec['phase_s']:.1f} s")
    return {"bf16": moon["k2_launches_bf16"] + n_whisper,
            "f32": n_small}, rec


# the simulator phase: the goldens' configuration (tests/test_policy_registry
# and tests/golden_policy_states.json), then the paper's 16 CPUs + 1 GPU on
# 4 memory channels (benchmarks/fig6_core_scaling.py: "paper: 4 MCs")
SIM_GOLDEN_POLICIES = ("frfcfs", "atlas", "parbs", "tcm", "sms", "sms_dash")
SIM_SOLO = ("frfcfs", "sms", "sms_dash")      # the paper batch, one by one
SIM_FAMILY = ("frfcfs", "atlas", "parbs", "tcm", "bliss", "squash_prio")
SIM_GOLDEN_CFG = dict(n_cpu=3, n_gpu=1, n_channels=2, buf_entries=24,
                      fifo_size=5, dcs_size=3)
SIM_GOLDEN_CYCLES = 1_500
SIM_GOLDEN_SCHED = {                 # keys that make the sched check real
    "sms": ("f_len", "f_row", "d_len", "d_src", "drain_left", "rr_bank"),
    "centralized": ("valid", "src", "bank", "row", "birth", "marked"),
}
# the grid checks, at the goldens' configuration: sms at two knob points on
# the folded step; a stacked grid with period and value overrides (the
# cpu_reserve override gives admission's per-row gpu_cap two values)
SIM_GRID_WARMUP, SIM_GRID_CYCLES = 100, 300    # 200 + 600 before the families
SIM_GRID_POINTS = ({}, {"dash": True})
SIM_STACKED_GRID = (("atlas", {"atlas_epoch": 100, "atlas_alpha": 0.75}),
                    ("frfcfs", {"cpu_reserve": 0.25}),
                    ("bliss", {"bliss_clear_interval": 150}),
                    ("tcm", {}))
SIM_N_CPU, SIM_CHANNELS, SIM_PER_CAT = 16, 4, 2
# far short of fig6's 12,000 cycles, so that the whole script, the families
# phase with it, stays near ten minutes (500 + 2,500 before the families)
SIM_WARMUP, SIM_CYCLES = 100, 600
SIM_PROFILE_CYCLES = 20
# the variable-step driver, the sanitizer and the recorder at the goldens'
# configuration: the sanitizer's clean runs and the faults at a short depth
SIM_CLEAN_CYCLES, SIM_FAULT_CYCLES = 300, 300
# the paper's widths with two accelerators under the bursty archetypes
# (workloads.bursty_batch), one W = 1 batch each, ticked and skipping
# (300 + 1,700 before the families phase)
SIM_BURSTY_WARMUP, SIM_BURSTY_CYCLES = 100, 500
SIM_BURSTY_PROFILE_STEPS = 12        # processed steps in a profiler window
# benchmarks/fig4_perf_fairness.py:25-30: SMS's WS gain over TCM and TCM's
# max slowdown over SMS's, from the paper (8 CPUs, 2 channels, 16,000 cycles)
SIM_FIG4_PAPER = "+41.2% / 4.8x"


def _sim_golden_pool(cfg):
    """The goldens' capture-time pool (seed 42)."""
    rng = np.random.RandomState(42)
    S = cfg.n_src
    mpki = rng.uniform(2, 40, S).astype(np.float32)
    pool = {
        "mpki": mpki,
        "inst_per_miss": np.maximum(1000.0 / mpki, 1.0).astype(np.float32),
        "rbl": rng.uniform(0.1, 0.95, S).astype(np.float32),
        "blp": rng.randint(1, 7, S).astype(np.int32),
        "is_gpu": np.asarray([False] * cfg.n_cpu + [True]),
        "dl_period": np.zeros(S, np.int32),
        "dl_reqs": np.zeros(S, np.int32),
    }
    pool["dl_period"][0] = 400
    pool["dl_reqs"][0] = 35
    return pool


def _sim_digest(tree):
    """Per-key sha1 over dtype, shape and bytes, as the goldens hold."""
    out = {}
    for key in sorted(tree):
        v = np.ascontiguousarray(tree[key])
        h = hashlib.sha1()
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
        out[key] = h.hexdigest()
    return out


def _sim_parity_config(n_cpu, n_channels, fifo_size=6, dcs_size=4,
                       n_hwa=0):
    """The centralized buffer sized to SMS's entry parity (the paper's
    comparison, benchmarks/common.parity_config)."""
    cfg = SimConfig(n_cpu=n_cpu, n_channels=n_channels, fifo_size=fifo_size,
                    dcs_size=dcs_size, n_hwa=n_hwa)
    return cfg.replace(buf_entries=cfg.n_src * cfg.fifo_size
                       + cfg.n_banks * cfg.dcs_size)


def _sim_batch():
    """The paper's configuration and one batch: the 14 shared workloads (two
    per intensity category) followed by the 23 alone runs, which give the
    per-benchmark baselines. Workloads never interact, so one batch is the
    two separate runs."""
    cfg = _sim_parity_config(SIM_N_CPU, SIM_CHANNELS)
    wls = sim_wl.make_workloads(SIM_N_CPU, n_per_cat=SIM_PER_CAT)
    pool, active = sim_wl.pool_batch(cfg, wls)
    apool, aactive, amap = sim_wl.alone_batch(cfg)
    both = {k: np.concatenate([pool[k], apool[k]]) for k in pool}
    return cfg, wls, pool, both, np.concatenate([active, aactive]), amap


def _sim_golden_batch(gcfg):
    pool = _sim_golden_pool(gcfg)
    return ({k: v[None] for k, v in pool.items()},
            np.ones((1, gcfg.n_src), bool))


def _sim_small_runs(device):
    """The goldens' configuration on `device`: every golden policy alone and
    the stackable family stacked (raw final states), and the grid checks
    (metrics). One flat dict of numpy arrays."""
    res = {}
    gcfg = SimConfig(**SIM_GOLDEN_CFG)
    gpool, on = _sim_golden_pool(gcfg), np.ones(gcfg.n_src, bool)
    for pol in SIM_GOLDEN_POLICIES:
        trees = sim.simulate_debug(gcfg, pol, gpool, on, SIM_GOLDEN_CYCLES,
                                   device=device)
        for part, tree in zip(("src", "sched", "dram"), trees):
            res.update({f"golden/{pol}/{part}/{k}": v
                        for k, v in tree.items()})
    stacked = sim.simulate_debug_stacked(gcfg, SIM_FAMILY, gpool, on,
                                         SIM_GOLDEN_CYCLES, device=device)
    for pol, trees in stacked.items():
        for part, tree in zip(("src", "sched", "dram"), trees):
            res.update({f"gstack/{pol}/{part}/{k}": v
                        for k, v in tree.items()})
    batch, active = _sim_golden_batch(gcfg)
    run = lambda c, pol: sim.simulate(c, pol, batch, active, SIM_GRID_CYCLES,
                                      SIM_GRID_WARMUP, device=device)
    runs = {"grid/sms": sim.simulate_grid(
        gcfg, "sms", SIM_GRID_POINTS, batch, active, SIM_GRID_CYCLES,
        SIM_GRID_WARMUP, device=device)}
    runs["solo"] = [run(gcfg, pol) for pol in ("sms", "sms_dash")]
    runs["sgrid"] = sim.simulate_stacked_grid(
        gcfg, SIM_STACKED_GRID, batch, active, SIM_GRID_CYCLES,
        SIM_GRID_WARMUP, device=device)
    # each stacked-grid slice alone, its overrides baked into the config
    runs["baked"] = [run(gcfg.replace(**ov), pol)
                     for pol, ov in SIM_STACKED_GRID]
    for name, slices in runs.items():
        for i, m in enumerate(slices):
            res.update({f"{name}/{i}/{k}": v for k, v in m.items()})
    res.update(_sim_skip_runs(gcfg, gpool, on, device))
    return res


def _sim_trees(prefix, trees):
    return {f"{prefix}/{part}/{k}": v
            for part, tree in zip(("src", "sched", "dram"), trees)
            for k, v in tree.items()}


def _sim_skip_runs(gcfg, gpool, on, device):
    """The goldens' configuration through the variable-step driver, the
    sanitizer and the recorder: every golden policy alone, skipping,
    sanitizer on, and the family stacked, skipping, recorder on; at
    a short depth, every policy ticked with the sanitizer on, bliss and
    squash_prio skipping, and the family stacked ticked and skipping with
    both on; each fault, as tests/test_validate.py drives it. One flat
    dict of numpy arrays."""
    res = {}
    vcfg = gcfg.replace(validate_enabled=True)
    for pol in SIM_GOLDEN_POLICIES:
        res.update(_sim_trees(f"gskip/{pol}", sim.simulate_debug(
            vcfg, pol, gpool, on, SIM_GOLDEN_CYCLES, skip=True,
            device=device)))
    for pol, trees in sim.simulate_debug_stacked(
            gcfg.replace(telemetry_enabled=True), SIM_FAMILY, gpool, on,
            SIM_GOLDEN_CYCLES, skip=True, device=device).items():
        res.update(_sim_trees(f"gskipstack/{pol}", trees))
    for pol in sim.ALL_POLICIES:
        res[f"clean/tick/{pol}"] = sim.simulate_debug(
            vcfg, pol, gpool, on, SIM_CLEAN_CYCLES, device=device)[2]["viol"]
    for pol in ("bliss", "squash_prio"):
        res[f"clean/skip/{pol}"] = sim.simulate_debug(
            vcfg, pol, gpool, on, SIM_CLEAN_CYCLES, skip=True,
            device=device)[2]["viol"]
    tcfg = vcfg.replace(telemetry_enabled=True)
    for mode in ("tick", "skip"):
        for pol, trees in sim.simulate_debug_stacked(
                tcfg, SIM_FAMILY, gpool, on, SIM_CLEAN_CYCLES,
                skip=mode == "skip", device=device).items():
            res.update(_sim_trees(f"{mode}stack/{pol}", trees))
    for name in sorted(sim_faults.FAULTS):
        skip = name in sim_faults.SKIP_ONLY
        pool = _sim_fault_pool(vcfg.n_src, idle=skip)
        with sim_faults.inject(name):
            if name in sim_faults.STACKED_ONLY:
                viol = sim.simulate_debug_stacked(
                    vcfg, ("frfcfs", "parbs"), pool, on, SIM_FAULT_CYCLES,
                    device=device)["parbs"][2]["viol"]
            else:
                viol = sim.simulate_debug(vcfg, "frfcfs", pool, on,
                                          SIM_FAULT_CYCLES, skip=skip,
                                          device=device)[2]["viol"]
        res[f"fault/{name}"] = viol
    return res


def _sim_fault_pool(S, idle=False, seed=7):
    """tests/test_validate.py's sanitizer pool (seed 7; idle-heavy for the
    faults of the span machinery)."""
    rs = np.random.RandomState(seed)
    pool = {
        "mpki": (np.full((S,), 0.5, np.float32) if idle
                 else rs.uniform(1.0, 40.0, S).astype(np.float32)),
        "inst_per_miss": rs.uniform(30.0, 300.0, S).astype(np.float32),
        "rbl": rs.uniform(0.1, 0.95, S).astype(np.float32),
        "blp": rs.randint(1, 5, S).astype(np.int32),
        "is_gpu": np.zeros((S,), bool),
        "dl_period": np.zeros((S,), np.int32),
        "dl_reqs": np.zeros((S,), np.int32),
        "dl_jitter": np.zeros((S,), np.int32),
    }
    if not idle:
        pool["is_gpu"][-1] = True
    pool["dl_period"][0] = int(rs.randint(200, 600))
    pool["dl_reqs"][0] = int(rs.randint(5, 40))
    return pool


def _sim_bursty():
    """The paper's widths with two accelerators: 16 CPUs + 1 GPU + 2 HWAs
    on 4 channels, the buffer at SMS's entry parity, and the four bursty
    archetypes (one row each)."""
    cfg = _sim_parity_config(SIM_N_CPU, SIM_CHANNELS, n_hwa=2)
    pool, active = sim_wl.bursty_batch(cfg)
    return cfg, pool, active


class _Counted:
    """A step that counts the cycles it processes."""

    def __init__(self, step):
        self.step, self.n = step, 0

    def __call__(self, carry, t, own=None):
        self.n += 1
        return self.step(carry, t, own)


def _sim_bursty_run(prep, device):
    """Run and measure a prepared bursty run: (metrics as numpy, seconds,
    processed steps, host reads). A ticked run on the card runs under the
    sync check; a skipping run cannot (it reads one int64 per processed
    step) and is timed without it."""
    cfg, step, body, carry = prep
    if body is None and device == "cuda":
        m, sec = _sim_timed(prep, SIM_BURSTY_CYCLES, SIM_BURSTY_WARMUP)
        return ({k: v.cpu().numpy() for k, v in m.items()}, sec,
                SIM_BURSTY_WARMUP + SIM_BURSTY_CYCLES, 0)
    step = _Counted(step)
    if device == "cuda":
        torch.cuda.synchronize()
    reads0 = sim.host_reads
    t0 = time.perf_counter()
    m = sim._scan_and_measure(cfg, step, body, carry, SIM_BURSTY_CYCLES,
                              SIM_BURSTY_WARMUP)
    m = {k: v.cpu().numpy() for k, v in m.items()}
    sec = time.perf_counter() - t0
    return m, sec, step.n, sim.host_reads - reads0


def _sim_bursty_runs(device):
    """The bursty archetypes at the paper's widths: the stacked family and
    sms ticked (the four archetypes in one W = 4 batch: rows never
    interact) and skipping (each archetype a W = 1 batch of its own: a
    batch pays for the union of its rows' events); one skipping run (the
    family on mixed_bursty) with the sanitizer and the recorder on.
    {name: (metrics, seconds, processed steps, host reads)}."""
    cfg, pool, active = _sim_bursty()
    out = {"tick/stacked": _sim_bursty_run(sim.prepare_stacked_run(
               cfg, SIM_FAMILY, pool, active, device=device), device),
           "tick/sms": _sim_bursty_run(sim.prepare_run(
               cfg, "sms", pool, active, device=device), device)}
    for a, arch in enumerate(sim_wl.BURSTY_ARCHETYPES):
        row = {k: v[a:a + 1] for k, v in pool.items()}
        act = active[a:a + 1]
        out[f"stacked/{arch}"] = _sim_bursty_run(sim.prepare_stacked_run(
            cfg, SIM_FAMILY, row, act, skip=True, device=device), device)
        out[f"sms/{arch}"] = _sim_bursty_run(sim.prepare_run(
            cfg, "sms", row, act, skip=True, device=device), device)
    a = sim_wl.BURSTY_ARCHETYPES.index("mixed_bursty")
    on = cfg.replace(validate_enabled=True, telemetry_enabled=True)
    out["stacked_on/mixed_bursty"] = _sim_bursty_run(sim.prepare_stacked_run(
        on, SIM_FAMILY, {k: v[a:a + 1] for k, v in pool.items()},
        active[a:a + 1], skip=True, device=device), device)
    return out


def _sim_profile_skip(prep):
    """Kernels per processed step and the device idle share from a
    torch.profiler window (device activity only) over the first
    SIM_BURSTY_PROFILE_STEPS processed steps of a prepared skipping run on
    the card (fewer where the run has fewer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    class Enough(Exception):
        pass

    def stop(carry, t):
        if sim.host_reads - reads0 >= SIM_BURSTY_PROFILE_STEPS:
            raise Enough
    _, step, body, carry = prep
    step(carry, 0)              # one warm-up cycle
    torch.cuda.synchronize()
    reads0 = sim.host_reads
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        try:
            sim._run_cycles(step, body, carry, 0,
                            SIM_BURSTY_WARMUP + SIM_BURSTY_CYCLES, stop)
        except Enough:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    n = max(sim.host_reads - reads0, 1)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.lower().startswith("memcpy")]
    busy_us = sum(e.device_time_total for e in dev)
    return {"profiled_steps": n,
            "kernels_per_step": (len(dev) - len(copies)) / n,
            "memcpy_per_step": len(copies) / n,
            "device_us_per_step": busy_us / n,
            "wall_us_per_step_profiled": 1e6 * wall / n,
            "device_idle_share": 1.0 - busy_us / (1e6 * wall)}


def _split_slices(metrics, names, W):
    """Folded (P·W, ...) metrics as {slice name: (W, ...) numpy}."""
    host = {k: v.cpu().numpy() for k, v in metrics.items()}
    return {n: {k: v[i * W:(i + 1) * W] for k, v in host.items()}
            for i, n in enumerate(names)}


def sim_cpu_worker(out_path, warmup=SIM_WARMUP, cycles=SIM_CYCLES):
    """The CPU half of the simulator phase, in a process of its own: the
    same calls as the card's, saved to `out_path`."""
    res = _sim_small_runs("cpu")
    cfg, _, _, both, active, _ = _sim_batch()
    for pol in SIM_SOLO:
        t0 = time.perf_counter()
        m = sim.simulate(cfg, pol, both, active, cycles, warmup,
                         device="cpu")
        res[f"seconds/{pol}"] = np.float64(time.perf_counter() - t0)
        res.update({f"paper/{pol}/{k}": v for k, v in m.items()})
    t0 = time.perf_counter()
    stk = sim.simulate_stacked(cfg, SIM_FAMILY, both, active, cycles, warmup,
                               device="cpu")
    res["seconds/stacked"] = np.float64(time.perf_counter() - t0)
    for pol, m in stk.items():
        res.update({f"pstack/{pol}/{k}": v for k, v in m.items()})
    for name, (m, sec, n, _) in _sim_bursty_runs("cpu").items():
        res.update({f"bursty/{name}/{k}": v for k, v in m.items()})
        res[f"seconds/bursty/{name}"] = np.float64(sec)
        res[f"steps/bursty/{name}"] = np.int64(n)
    np.savez(out_path, **res)


def _sim_ws_maxsd(cfg, wls, pool, m, amap):
    """The paper's WS and max slowdown, averaged over the shared workloads,
    from one batch's metrics (shared rows first, then the alone rows)."""
    n = len(wls)
    alone = sim_wl.alone_perf_lookup(
        cfg, {k: v[n:] for k, v in m.items()}, amap)
    perf = sim.perf_vector(cfg, {k: v[:n] for k, v in m.items()}, pool)
    rows = [sim_met.workload_metrics(cfg, w, perf[i], alone)
            for i, w in enumerate(wls)]
    return sim_met.aggregate(rows)


def _sim_profile(step, carry):
    """Kernels per simulated cycle (and the device's share of the wall time)
    from a short torch.profiler window over a prepared step on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for t in range(5):
        carry, _ = step(carry, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(5, 5 + SIM_PROFILE_CYCLES):
            carry, _ = step(carry, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.lower().startswith("memcpy")]
    copy_names = sorted({e.name for e in copies})
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    busy_us = sum(e.device_time_total for e in dev)
    n = SIM_PROFILE_CYCLES
    return {"kernels_per_cycle": (len(dev) - len(copies)) / n,
            "memcpy_per_cycle": len(copies) / n,
            "memcpy_kinds": copy_names,
            "cudaLaunchKernel_per_cycle": launches / n,
            "device_us_per_cycle": busy_us / n,
            "wall_us_per_cycle_profiled": 1e6 * wall / n,
            "device_idle_share": 1.0 - busy_us / (1e6 * wall)}


def _sim_timed(prep, cycles, warmup):
    """Run a prepared ticked (cfg, step, None, carry) under the sync check;
    (metrics, seconds)."""
    cfg, step, body, carry = prep
    if body is not None:
        raise ValueError("the sync check times ticked runs only")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = sim._scan_and_measure(cfg, step, None, carry, cycles, warmup)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def _sim_same(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


def _sim_check_goldens(golden, card):
    """The card's goldens' runs against tests/golden_policy_states.json:
    every golden policy alone, and the stacked family slice by slice,
    ticked and skipping (the skipping runs with the sanitizer on, the
    stacked one with the recorder too)."""
    stacked = [p for p in SIM_FAMILY if p in golden]
    for prefix, pols in (("golden", SIM_GOLDEN_POLICIES),
                         ("gstack", stacked),
                         ("gskip", SIM_GOLDEN_POLICIES),
                         ("gskipstack", stacked)):
        for pol in pols:
            g = golden[pol]
            essential = SIM_GOLDEN_SCHED[
                "sms" if pol.startswith("sms") else "centralized"]
            for part in ("src", "sched", "dram"):
                pre = f"{prefix}/{pol}/{part}/"
                new = _sim_digest({k[len(pre):]: v for k, v in card.items()
                                   if k.startswith(pre)})
                keys = set(g[part]) & set(new) if part == "sched" \
                    else set(g[part])
                if part == "sched" and not set(essential) <= keys:
                    raise AssertionError(f"sim {prefix} {pol}: sched keys "
                                         f"{sorted(keys)}")
                bad = sorted(k for k in keys if new.get(k) != g[part][k])
                if bad:
                    raise AssertionError(f"sim {prefix} {pol} {part}: "
                                         f"digests differ on card: {bad}")


def _sim_run(card, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in card.items() if k.startswith(pre)}


def _sim_check_skip_small(card):
    """On one device, the goldens' configuration: every sanitizer counter
    zero on the clean runs (every policy ticked, the skipping runs solo and
    stacked); each fault flips one of its TARGETS counters; the family
    stacked, skipping with the recorder on, equals the ticked run with it
    off in every other array; the ticked and skipping runs with the
    sanitizer and the recorder on have equal rings but for the `steps`
    channel.
    Returns {fault: nonzero counters}."""
    clean = {k: v for k, v in card.items() if k.startswith("clean/")
             or k.endswith("/dram/viol")}
    dirty = sorted(k for k, v in clean.items() if np.any(v))
    if len(clean) < 2 * len(sim.ALL_POLICIES) or dirty:
        raise AssertionError(f"sim sanitizer: counters on clean runs "
                             f"{dirty} of {len(clean)}")
    flips = {}
    for name, targets in sim_faults.TARGETS.items():
        summary = sim_val.summarize(card[f"fault/{name}"])
        flips[name] = {k: v for k, v in summary.items() if v}
        if not sum(summary[k] for k in targets):
            raise AssertionError(f"sim fault {name}: no target counter "
                                 f"flipped ({flips[name]})")
    own = {f"dram/{k}" for k in sim_tel.STATE_KEYS}
    n = sim_tel.N_INVARIANT
    for pol in SIM_FAMILY:
        off, on = (_sim_run(card, f"{p}/{pol}") for p in ("gstack",
                                                          "gskipstack"))
        if set(on) - set(off) != own or not all(
                _sim_same(on[k], off[k]) for k in off):
            raise AssertionError(f"sim recorder: {pol} skipping with the "
                                 f"recorder != ticked without")
        tick, skip = (_sim_run(card, f"{p}stack/{pol}") for p in ("tick",
                                                                  "skip"))
        same = all(_sim_same(tick[k], skip[k]) for k in tick
                   if k != "dram/tl_ring")
        if not same or not _sim_same(tick["dram/tl_ring"][:, :n],
                                     skip["dram/tl_ring"][:, :n]):
            raise AssertionError(f"sim recorder: {pol} ring differs ticked "
                                 f"vs skipping")
    return flips


def _sim_check_bursty(cfg, bursty, bprof, cpu, smi_line, seconds):
    """The bursty archetypes on the card: every skipping run equals its
    archetype's row of the ticked batch in every metric but `sim_steps`;
    every run (its `sim_steps` too) equals the CPU's; host reads equal
    processed steps; the sanitizer and recorder run is clean, equals the
    run with both off, and its ring equals the CPU's. Prints, per
    archetype, the skip ratio, processed steps, slice-cycles/s ticked and
    skipping, kernels per processed step and the idle share."""
    P, n_cyc = len(SIM_FAMILY), SIM_BURSTY_WARMUP + SIM_BURSTY_CYCLES
    for name, (m, _, n, reads) in bursty.items():
        for k, v in m.items():
            if not _sim_same(v, cpu[f"bursty/{name}/{k}"]):
                raise AssertionError(f"sim bursty {name} {k}: card != cpu")
        if name.startswith("tick/"):
            continue
        if reads != n or n != int(cpu[f"steps/bursty/{name}"]):
            raise AssertionError(f"sim bursty {name}: {reads} host reads, "
                                 f"{n} processed steps (cpu "
                                 f"{int(cpu[f'steps/bursty/{name}'])})")
    W = len(sim_wl.BURSTY_ARCHETYPES)
    tick = {"stacked": {pol: {k: v[i * W:(i + 1) * W] for k, v in
                              bursty["tick/stacked"][0].items()}
                        for i, pol in enumerate(SIM_FAMILY)},
            "sms": {"sms": bursty["tick/sms"][0]}}
    rec = {}
    for a, arch in enumerate(sim_wl.BURSTY_ARCHETYPES):
        for run in ("stacked", "sms"):
            m, sec, n, reads = bursty[f"{run}/{arch}"]
            pols = SIM_FAMILY if run == "stacked" else ("sms",)
            for i, pol in enumerate(pols):
                want = tick[run][pol]
                got = {k: v[i:i + 1] for k, v in m.items()}
                bad = [k for k in want if k != "sim_steps"
                       and not _sim_same(got[k], want[k][a:a + 1])]
                if bad or not (want["sim_steps"] == SIM_BURSTY_CYCLES).all():
                    raise AssertionError(f"sim bursty {arch} {pol}: "
                                         f"skipping != ticked on {bad}")
            steps = float(m["sim_steps"][0])
            n_sl = len(pols)
            tick_s = bursty[f"tick/{run}"][1]
            pr = bprof[f"{run}/{arch}"]
            r = {"skip_ratio": 1.0 - steps / SIM_BURSTY_CYCLES,
                 "sim_steps": steps, "processed_steps": n,
                 "host_reads_per_step": reads / n,
                 "slice_cycles_per_s_skip": n_sl * n_cyc / sec,
                 "slice_cycles_per_s_tick": n_sl * n_cyc / tick_s,
                 "seconds_skip": sec, "seconds_tick_w4": tick_s,
                 "seconds_skip_cpu": float(
                     cpu[f"seconds/bursty/{run}/{arch}"]), **pr}
            rec[f"{run}/{arch}"] = r
            print(f"[sim] bursty {arch:12s} {run:7s}: skip ratio "
                  f"{r['skip_ratio']:.4f} ({steps:.0f} of "
                  f"{SIM_BURSTY_CYCLES} measured cycles; {n} processed "
                  f"steps of {n_cyc}, {r['host_reads_per_step']:g} host "
                  f"read each); slice-cycles/s "
                  f"skipping {r['slice_cycles_per_s_skip']:.1f} (cpu "
                  f"{n_sl * n_cyc / r['seconds_skip_cpu']:.1f}), ticked "
                  f"{r['slice_cycles_per_s_tick']:.1f} (the W=4 batch); "
                  f"{pr['kernels_per_step']:.1f} kernels per processed step "
                  f"over {pr['profiled_steps']} steps, device "
                  f"{pr['device_us_per_step']:.1f} of "
                  f"{pr['wall_us_per_step_profiled']:.1f} us, idle share "
                  f"{pr['device_idle_share']:.3f}; {smi_line}")
    m_on = bursty["stacked_on/mixed_bursty"][0]
    m_off = bursty["stacked/mixed_bursty"][0]
    if np.any(m_on["violations"]) or not all(
            _sim_same(m_on[k], v) for k, v in m_off.items()):
        raise AssertionError("sim bursty: the sanitizer and recorder run is "
                             "not clean or differs from the run without")
    print(f"[sim] bursty at the paper's widths: {cfg.n_cpu} CPUs + 1 GPU + "
          f"{cfg.n_hwa} HWAs on {cfg.n_channels} channels, "
          f"{cfg.buf_entries} buffer entries; {SIM_BURSTY_WARMUP} warm-up + "
          f"{SIM_BURSTY_CYCLES} measured cycles; {', '.join(SIM_FAMILY)} "
          f"stacked and sms: skipping == ticked in every metric but "
          f"sim_steps, card == cpu (sim_steps too), host reads == processed "
          f"steps; the family on mixed_bursty with the sanitizer and the "
          f"recorder: {sim_val.NV} counters 0, == the run without, ring == "
          f"cpu; ticked runs under the sync check, skipping runs without "
          f"it ({seconds:.1f} s)")
    return rec


def _sim_check_grids(card):
    """On one device: the sms grid's two points equal sms and sms_dash
    alone, and each stacked-grid slice equals its own run alone with its
    overrides baked into the config (all but the shared `sim_steps`)."""
    def run(name, i):
        pre = f"{name}/{i}/"
        return {k[len(pre):]: v for k, v in card.items()
                if k.startswith(pre)}
    pairs = [(("grid/sms", i), ("solo", i), f"sms point {i}")
             for i in range(len(SIM_GRID_POINTS))]
    pairs += [(("sgrid", i), ("baked", i), f"stacked grid slice {i}")
              for i in range(len(SIM_STACKED_GRID))]
    for a, b, what in pairs:
        got, want = run(*a), run(*b)
        if not want or got.keys() != want.keys() or not all(
                _sim_same(got[k], want[k]) for k in want
                if k != "sim_steps"):
            raise AssertionError(f"sim grid: {what} != its run alone")


def phase_sim(smi_line, warmup=SIM_WARMUP, cycles=SIM_CYCLES):
    """The cycle simulator (src/repro_torch/core) on the card, every result
    equal to the same call on the CPU (a second process, run alongside):
    the goldens' configuration (every golden policy alone and the stackable
    family stacked reproduce tests/golden_policy_states.json; the grid
    checks); then the paper's 16-core + 1-GPU, 4-channel system: the six
    stackable policies in ONE stacked run, sms and sms_dash alone, and
    frfcfs alone, which must equal its stacked slice. The timed loops run
    under torch.cuda.set_sync_debug_mode("error"): they never wait for the
    card."""
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "sim")       # git-ignored
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"cpu-{os.getpid()}.npz")
    worker = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sim-cpu-worker", out_path,
                               "--sim-cycles", f"{warmup},{cycles}"])
    try:
        _zero_counts()
        with open(os.path.join(ROOT, "tests",
                               "golden_policy_states.json")) as f:
            golden = json.load(f)
        t_small = time.perf_counter()
        card_small = _sim_small_runs("cuda")
        _sim_check_goldens(golden, card_small)
        _sim_check_grids(card_small)
        flips = _sim_check_skip_small(card_small)
        t_small = time.perf_counter() - t_small
        print(f"[sim] goldens on the card: {', '.join(SIM_GOLDEN_POLICIES)} "
              f"alone and {', '.join(SIM_FAMILY)} stacked at "
              f"{SIM_GOLDEN_CYCLES} cycles, ticked and skip=True (the "
              f"skipping runs with the sanitizer on, the stacked one with "
              f"the recorder too), reproduce every src, dram and sched "
              f"digest of tests/golden_policy_states.json (the stacked "
              f"slices of every golden policy); sms at knob points "
              f"{list(SIM_GRID_POINTS)} == sms, sms_dash alone; each slice "
              f"of the stacked grid {[list(s) for s in SIM_STACKED_GRID]} "
              f"== its run alone, overrides baked ({t_small:.1f} s)")
        print(f"[sim] sanitizer: all {sim_val.NV} counters 0 for "
              f"{', '.join(sim.ALL_POLICIES)} ticked ({SIM_CLEAN_CYCLES} "
              f"cycles) and skipping, solo and stacked; faults on the card "
              f"({SIM_FAULT_CYCLES} cycles, SKIP_ONLY through skip=True, "
              f"stacked_writeset stacked): {json.dumps(flips)}; recorder: "
              f"the family stacked, skipping with it on, == ticked with it "
              f"off in every other array; its first "
              f"{sim_tel.N_INVARIANT} channels equal ticked and skipping")

        t_paper = time.perf_counter()
        cfg, wls, pool, both, active, amap = _sim_batch()
        W = active.shape[0]
        card, card_s, prof = {}, {}, {}
        for pol in SIM_SOLO:
            m, card_s[pol] = _sim_timed(
                sim.prepare_run(cfg, pol, both, active, device="cuda"),
                cycles, warmup)
            card[pol] = {k: v.cpu().numpy() for k, v in m.items()}
        m, card_s["stacked"] = _sim_timed(
            sim.prepare_stacked_run(cfg, SIM_FAMILY, both, active,
                                    device="cuda"), cycles, warmup)
        stacked = _split_slices(m, SIM_FAMILY, W)
        for pol in SIM_SOLO:
            _, step, _, carry = sim.prepare_run(cfg, pol, both, active,
                                                device="cuda")
            prof[pol] = _sim_profile(step, carry)
        _, step, _, carry = sim.prepare_stacked_run(cfg, SIM_FAMILY, both,
                                                    active, device="cuda")
        prof["stacked"] = _sim_profile(step, carry)
        t_paper = time.perf_counter() - t_paper
        t_b = time.perf_counter()
        bursty = _sim_bursty_runs("cuda")
        bcfg, bpool, bactive = _sim_bursty()
        bprof = {}
        for a, arch in enumerate(sim_wl.BURSTY_ARCHETYPES):
            row = {k: v[a:a + 1] for k, v in bpool.items()}
            act = bactive[a:a + 1]
            bprof[f"stacked/{arch}"] = _sim_profile_skip(
                sim.prepare_stacked_run(bcfg, SIM_FAMILY, row, act, skip=True,
                                        device="cuda"))
            bprof[f"sms/{arch}"] = _sim_profile_skip(
                sim.prepare_run(bcfg, "sms", row, act, skip=True,
                                device="cuda"))
        t_b = time.perf_counter() - t_b
        launched = {fn.__name__: fn.launches for fn in
                    (ops.paged_attention, fa_ops.flash_attention,
                     ml_ops.mlstm_scan)}
        if any(launched.values()):
            raise AssertionError(f"the simulator path launched {launched}")
        for k, v in card["frfcfs"].items():
            if not _sim_same(stacked["frfcfs"][k], v):
                raise AssertionError(f"sim paper: stacked frfcfs {k} != "
                                     f"frfcfs alone on the card")

        t_wait = time.perf_counter()
        worker.wait(timeout=900)
        t_wait = time.perf_counter() - t_wait
        print(f"[sim] sections: goldens, grids, sanitizer and faults "
              f"{t_small:.1f} s; paper batch {t_paper:.1f} s; bursty "
              f"{t_b:.1f} s; waiting for the CPU worker {t_wait:.1f} s")
        if worker.returncode != 0:
            raise AssertionError(f"sim CPU worker exit {worker.returncode}")
        cpu = np.load(out_path)
        for k, v in card_small.items():
            if not _sim_same(v, cpu[k]):
                raise AssertionError(f"sim {k}: card != cpu")
        for prefix, runs in (("paper", card), ("pstack", stacked)):
            for pol, mets in runs.items():
                for k, v in mets.items():
                    if not _sim_same(v, cpu[f"{prefix}/{pol}/{k}"]):
                        raise AssertionError(f"sim {prefix} {pol} {k}: "
                                             f"card != cpu")
        rec_b = _sim_check_bursty(bcfg, bursty, bprof, cpu, smi_line, t_b)
        n_cyc = warmup + cycles
        S = active.shape[1]
        P = len(SIM_FAMILY)
        print(f"[sim] paper system: {SIM_N_CPU} CPUs + 1 GPU, "
              f"{cfg.n_channels} channels x {cfg.n_banks} banks, "
              f"{cfg.buf_entries} buffer entries per channel (SMS FIFO "
              f"{cfg.fifo_size}, DCS {cfg.dcs_size}); W={W} workloads "
              f"({len(wls)} shared + {W - len(wls)} alone) x S={S}, "
              f"{warmup} warm-up + {cycles} measured cycles; "
              f"{', '.join(SIM_FAMILY)} in ONE stacked run on P*W = "
              f"{P * W} rows, {', '.join(SIM_SOLO)} alone; every metric "
              f"card == cpu; the stacked frfcfs slice == frfcfs alone; no "
              f"sync in the timed loops; kernel launches on the path "
              f"{json.dumps(launched)}")
        rec = {}
        results = {**stacked, **{p: card[p] for p in SIM_SOLO
                                 if p != "frfcfs"}}
        for pol in sim.ALL_POLICIES:
            if pol not in results:
                continue
            a = _sim_ws_maxsd(cfg, wls, pool, results[pol], amap)
            rec[pol] = {"ws": a["weighted_speedup"],
                        "max_slowdown": a["max_slowdown"],
                        "cpu_ws": a["cpu_weighted_speedup"],
                        "gpu_su": a["gpu_speedup"],
                        "run": "stacked" if pol in stacked else "alone"}
            print(f"[sim] {pol:12s} WS {a['weighted_speedup']:.4f}, max "
                  f"slowdown {a['max_slowdown']:.4f}, cpuWS "
                  f"{a['cpu_weighted_speedup']:.4f}, gpuSU "
                  f"{a['gpu_speedup']:.4f} ({rec[pol]['run']})")
        gain = rec["sms"]["ws"] / rec["tcm"]["ws"] - 1.0
        fair = rec["tcm"]["max_slowdown"] / rec["sms"]["max_slowdown"]
        rec["fig4"] = {"sms_ws_gain_over_tcm": gain,
                       "tcm_maxsd_over_sms": fair}
        print(f"[sim] fig4: SMS over TCM, WS {100 * gain:+.1f}%, max "
              f"slowdown {fair:.2f}x (paper {SIM_FIG4_PAPER}; fig4 runs 8 "
              f"CPUs on 2 channels for 16,000 cycles, this runs "
              f"{SIM_N_CPU} CPUs on {cfg.n_channels} channels for "
              f"{cycles:,})")
        speed = {}
        for name in SIM_SOLO + ("stacked",):
            n = P if name == "stacked" else 1
            cpu_s = float(cpu[f"seconds/{name}"])
            speed[name] = {"slice_cycles_per_s_card": n * n_cyc
                           / card_s[name],
                           "slice_cycles_per_s_cpu": n * n_cyc / cpu_s,
                           "seconds_card": card_s[name],
                           "seconds_cpu": cpu_s, **prof[name]}
            pr = prof[name]
            print(f"[sim] {name}: {n} slice(s) x {n_cyc} cycles, card "
                  f"{card_s[name]:.2f} s = "
                  f"{speed[name]['slice_cycles_per_s_card']:.1f} "
                  f"slice-cycles/s, cpu {cpu_s:.2f} s = "
                  f"{speed[name]['slice_cycles_per_s_cpu']:.1f} (cpu run "
                  f"alongside); {pr['kernels_per_cycle']:.1f} kernels, "
                  f"{pr['memcpy_per_cycle']:.2f} copies "
                  f"{pr['memcpy_kinds']}, "
                  f"{pr['cudaLaunchKernel_per_cycle']:.1f} cudaLaunchKernel "
                  f"per cycle; device {pr['device_us_per_cycle']:.1f} us of "
                  f"{pr['wall_us_per_cycle_profiled']:.1f} us per profiled "
                  f"cycle (idle share {pr['device_idle_share']:.3f}); "
                  f"{smi_line}")
        rec["speed"] = speed
        rec["bursty"] = rec_b
        print(f"[sim] {json.dumps({'sim': rec})}")
        print(f"[sim] phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
        if os.path.exists(out_path):
            os.remove(out_path)
    return rec


# the distribution phase (slice F): the sharded paths over meshes on the one
# card (NCCL at world 1; gloo ranks that share the card), and the dry-run's
# per-chip counts on fake worlds of 256 and 512 ranks

DIST_QWEN_LAYERS = TRAIN_QWEN_LAYERS      # slice T's cut (f32 AdamW state)
DIST_TRAIN_B, DIST_TRAIN_S, DIST_TRAIN_STEPS = 1, 2048, 3
DIST_TRAIN_LR = 3e-4
DIST_PREFILL_B, DIST_PREFILL_S = 1, 4096
DIST_PREFILL_CALLS = 2                   # the second is timed
DIST_RANKS = 4
DIST_MOE_LAYERS, DIST_MOE_B, DIST_MOE_S = 2, 1, 4096
DIST_PP_BLOCKS, DIST_PP_MICRO, DIST_PP_B, DIST_PP_S = 2, 4, 4, 512
DIST_DRYRUNS = {
    "qwen1.5-4b train_4k single_pod": [
        "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-4b",
        "--shape", "train_4k", "--mesh", "single_pod", "--force"],
    "qwen1.5-4b train_4k multi_pod": [
        "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-4b",
        "--shape", "train_4k", "--mesh", "multi_pod", "--force"],
    "gemma2-2b pipeline": ["-m", "repro_torch.launch.dryrun_pp",
                           "--arch", "gemma2-2b"]}
DIST_RECORDS = {
    "qwen1.5-4b train_4k single_pod":
        "qwen1.5-4b__train_4k__single_pod.json",
    "qwen1.5-4b train_4k multi_pod": "qwen1.5-4b__train_4k__multi_pod.json",
    "gemma2-2b pipeline": "PP__gemma2-2b__train_4k__multi_pod.json"}


def _dist_train(mesh):
    """(a) three train steps of Qwen1.5-4B (full width, 8 layers, f32) on
    the (1, 1) mesh against the unsharded step from the same weights."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b"),
                              n_layers=DIST_QWEN_LAYERS)
    run = RunConfig(seq_len=DIST_TRAIN_S, global_batch=DIST_TRAIN_B,
                    lr=DIST_TRAIN_LR, warmup_steps=1,
                    total_steps=DIST_TRAIN_STEPS, compute_dtype="float32",
                    remat="full")
    shape = ShapeConfig("train", "train", DIST_TRAIN_S, DIST_TRAIN_B)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = get_model(cfg).init(gen)
    init = _tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size,
                         (DIST_TRAIN_STEPS, DIST_TRAIN_B, DIST_TRAIN_S + 1),
                         generator=gen, device="cuda")
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]

    def steps_of(fn, params):
        opt, err = adamw.init(params), torch.zeros((), device="cuda")
        losses, ms = [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, err, m = fn(params, opt, err, b, i)
            losses.append(float(m["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        return _tree_to(shlib.full(params), "cpu"), losses, ms

    want, l_plain, ms_plain = steps_of(
        train_steps.build_train_step(cfg, run, shape), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    got, l_mesh, ms_mesh = steps_of(
        train_steps.build_train_step(cfg, run, shape, mesh),
        _tree_to(init, "cuda"))
    del init
    _assert_close("dist train losses (1, 1) mesh vs unsharded",
                  torch.tensor(l_mesh), torch.tensor(l_plain), F32_TOL)
    atol = F32_TOL["atol"] + 0.1 * DIST_TRAIN_LR * DIST_TRAIN_STEPS
    err = max(_assert_close(f"dist train param {k}", a, b,
                            dict(atol=atol, rtol=F32_TOL["rtol"]))
              for (k, a), b in zip(tree_lib.flatten_with_path(got),
                                   tree_lib.leaves(want)))
    same = l_mesh == l_plain and all(
        torch.equal(a, b) for a, b in zip(tree_lib.leaves(got),
                                          tree_lib.leaves(want)))
    return {"config": f"{cfg.name} ({cfg.n_layers} of 40 layers), f32, "
                      f"B={DIST_TRAIN_B} S={DIST_TRAIN_S}, remat full",
            "losses_mesh": l_mesh, "losses_unsharded": l_plain,
            "param_max_abs_err": err, "bit_identical": same,
            "step_ms_mesh": ms_mesh, "step_ms_unsharded": ms_plain}


def _dist_prefill(mesh):
    """(a) the sharded prefill of Qwen1.5-4B at full width and depth, bf16,
    with use_pallas: K2 once per layer on the local head shards, the logits
    against the unsharded prefill with the plain attention. Each runs twice;
    the second call is timed."""
    cfg = get_config("qwen1.5-4b")
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = get_model(cfg).init(gen, torch.bfloat16)
    run = RunConfig(compute_dtype="bfloat16", use_pallas=True)
    shape = ShapeConfig("prefill", "prefill", DIST_PREFILL_S, DIST_PREFILL_B)
    toks = torch.randint(0, cfg.vocab_size, (DIST_PREFILL_B, DIST_PREFILL_S),
                         generator=gen, device="cuda")
    sharded = train_steps.build_prefill_step(cfg, run, shape, mesh)
    plain = train_steps.build_prefill_step(cfg, run.replace(use_pallas=False),
                                           shape)

    def timed(fn):
        for _ in range(DIST_PREFILL_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache, _ = fn(params, toks)
            del cache
            torch.cuda.synchronize()
        return lg, 1e3 * (time.perf_counter() - t0)

    with torch.no_grad():
        _zero_counts()
        lg, mesh_ms = timed(sharded)
        lg = lg.full_tensor()
        launches = fa_ops.flash_attention.launches
        launches_bf16 = fa_ops.flash_attention.launches_bf16
        ref, plain_ms = timed(plain)
        del params
    if launches != cfg.n_layers * DIST_PREFILL_CALLS or \
            launches_bf16 != launches:
        raise AssertionError(f"dist prefill: K2 launches {launches} (bf16 "
                             f"route {launches_bf16}) != {cfg.n_layers} x "
                             f"{DIST_PREFILL_CALLS}")
    err = _assert_close("dist prefill logits (1, 1) mesh + K2 vs unsharded "
                        "plain", lg, ref, BF16_TOL, rtol_of_max=True)
    return {"config": f"{cfg.name} (40 layers), bf16, B={DIST_PREFILL_B} "
                      f"S={DIST_PREFILL_S}, use_pallas",
            "k2_launches": launches, "k2_launches_bf16": launches_bf16,
            "logits_max_abs_err": err, "max_abs_logit": float(ref.abs().max()),
            "prefill_ms_mesh": mesh_ms, "prefill_ms_unsharded_plain": plain_ms}


def _dist_moe(rank):
    """(b) moonshot's MoE layers at full width (2 blocks' worth), expert
    parallel over model = 4 ranks on the card, against the local path,
    layer by layer on the same input (the local stream's): random weights
    grow the stream and a rounding difference flips near-tied expert
    choices downstream, so a free-running comparison meets no bf16 bar
    (the families phase found the same); here the router sees the same
    input, so the EP path must choose the same experts."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              n_layers=DIST_MOE_LAYERS)
    mesh = init_device_mesh("cuda", (1, DIST_RANKS),
                            mesh_dim_names=("data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    blocks = lm.init(gen, cfg, torch.bfloat16)["blocks"]
    x = torch.randn(DIST_MOE_B, DIST_MOE_S, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    run = RunConfig(compute_dtype="bfloat16")
    routes, route = [], moe_lib._route

    def recording(x, router, c):
        out = route(x, router, c)
        routes.append(out[0])
        return out

    errs, changed, top, ep_ms, local_ms = [], [], 0.0, 0.0, 0.0
    moe_lib._route = recording
    try:
        with torch.no_grad():
            for i in range(cfg.n_layers):
                p = lm._layer(blocks, i)
                h = rms_norm(x, p["ln2"], cfg.norm_eps)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with implicit_replication():
                    y_ep = moe_lib.moe_apply(h, p["moe"], cfg, run,
                                             mesh)[0].full_tensor()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                y = moe_lib.moe_apply(h, p["moe"], cfg, run)[0]
                torch.cuda.synchronize()
                ep_ms += 1e3 * (t1 - t0)
                local_ms += 1e3 * (time.perf_counter() - t1)
                errs.append(_assert_close(
                    f"dist EP moe layer {i} vs local path", y_ep, y,
                    BF16_TOL, rtol_of_max=True))
                ep_idx, idx = routes[-2:]
                changed.append(int((ep_idx != idx).any(-1).sum()))
                top = max(top, float(y.abs().max()))
                x = x + y
    finally:
        moe_lib._route = route
    return {"config": f"{cfg.name} MoE layers of {cfg.n_layers} blocks "
                      f"(d {cfg.d_model}, {cfg.n_experts} experts of "
                      f"{cfg.moe_d_ff}, top-{cfg.top_k}, shared expert), "
                      f"bf16, B={DIST_MOE_B} S={DIST_MOE_S}, model = "
                      f"{DIST_RANKS}, layer by layer",
            "max_abs_err": max(errs), "max_abs_value": top,
            "tokens_changing_experts_per_layer": changed,
            "ep_ms": ep_ms, "local_ms": local_ms}


def _dist_gpipe(rank):
    """(b) GPipe: 4 stages of 2 Qwen1.5-4B blocks (full width, f32), 4
    microbatches; the output and each stage's gradients against the 8
    blocks in order."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.pipeline import (gpipe_apply,
                                                  split_layers_to_stages)
    from repro_torch.models.common import init_stacked
    n = DIST_RANKS * DIST_PP_BLOCKS
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=n)
    mesh = init_device_mesh("cuda", (DIST_RANKS,), mesh_dim_names=("pod",))
    gen = torch.Generator(device="cuda").manual_seed(8)
    blocks = init_stacked(gen, lm.block_defs(cfg), n)
    x = torch.randn(DIST_PP_B, DIST_PP_S, cfg.d_model, generator=gen,
                    device="cuda")
    run = RunConfig(compute_dtype="float32", remat="none")

    def stage(p, h):
        for i in range(DIST_PP_BLOCKS):
            h = lm.apply_block(lm._layer(p, i), cfg, run, h, window=0)[0]
        return h

    staged = split_layers_to_stages(blocks, DIST_RANKS)
    leaves = [t.detach().requires_grad_() for t in tree_lib.leaves(staged)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gpipe_apply(stage, tree_lib.unflatten(staged, leaves), x,
                      DIST_PP_MICRO, mesh)
    out.square().mean().backward()
    torch.cuda.synchronize()
    pp_ms = 1e3 * (time.perf_counter() - t0)
    ref_leaves = [t.detach().requires_grad_()
                  for t in tree_lib.leaves(blocks)]
    ref_blocks = tree_lib.unflatten(blocks, ref_leaves)
    t0 = time.perf_counter()
    h = x
    for i in range(n):
        h = lm.apply_block(lm._layer(ref_blocks, i), cfg, run, h,
                           window=0)[0]
    h.square().mean().backward()
    torch.cuda.synchronize()
    seq_ms = 1e3 * (time.perf_counter() - t0)
    sidx = mesh.get_local_rank("pod")
    err_out = _assert_close("dist gpipe output vs blocks in order",
                            out.detach(), h.detach(), F32_TOL,
                            rtol_of_max=True)
    lo = sidx * DIST_PP_BLOCKS
    err_g = max(_assert_close(f"dist gpipe grad stage {sidx}",
                              a.grad[sidx], b.grad[lo:lo + DIST_PP_BLOCKS],
                              F32_TOL, rtol_of_max=True)
                for a, b in zip(leaves, ref_leaves))
    errs = coll.all_reduce(torch.tensor([err_out, err_g], device="cuda"),
                           mesh.get_group("pod"), "max")
    return {"config": f"{cfg.name} blocks, {DIST_RANKS} stages of "
                      f"{DIST_PP_BLOCKS}, f32, B={DIST_PP_B} S={DIST_PP_S}, "
                      f"n_micro {DIST_PP_MICRO}",
            "output_max_abs_err": float(errs[0]),
            "grad_max_abs_err": float(errs[1]), "gpipe_ms": pp_ms,
            "sequential_ms": seq_ms}


def _dist_rank(rank, world, out):
    """One gloo rank of (b): its tensors on the card."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"moe": _dist_moe(rank)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["gpipe"] = _dist_gpipe(rank)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rec, f)


def phase_dist(smi_line):
    """The distribution layer: (a) NCCL at world 1 on a (1, 1) mesh: three
    sharded train steps against the unsharded ones, the sharded prefill
    through K2; (b) 4 gloo ranks whose tensors all live on the card (NCCL
    refuses two ranks on one GPU; gloo moves CUDA tensors through the
    host): the expert-parallel MoE and GPipe; (c) the dry-run of
    qwen1.5-4b x train_4k on 256 and 512 fake ranks and the GPipe dry-run of
    gemma2-2b, in processes that run alongside (CPU, meta tensors). Returns
    K2's launches (all on the bf16 route)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import world
    from repro_torch.launch import dryrun as dryrun_lib
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dist")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for name, argv in DIST_DRYRUNS.items():
        log = open(os.path.join(out_dir, name.replace(" ", "_") + ".log"),
                   "w")
        procs[name] = (subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                        env=env, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, time.perf_counter())
    try:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(out_dir, "nccl"),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            train = _dist_train(mesh)
            gc.collect()
            torch.cuda.empty_cache()
            prefill = _dist_prefill(mesh)
        finally:
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        ranks_out = os.path.join(out_dir, "ranks.json")
        world.spawn(_dist_rank, DIST_RANKS, os.path.join(out_dir, "gloo"),
                    args=(ranks_out,))
        with open(ranks_out) as f:
            ranks = json.load(f)
        ranks["phase_s"] = time.perf_counter() - t_b
        dry = {}
        for name, (proc, log, start) in procs.items():
            rc = proc.wait(timeout=900)
            log.close()
            if rc:
                raise AssertionError(f"dist dry-run {name} exited {rc}")
            with open(os.path.join(dryrun_lib.OUT_DIR,
                                   DIST_RECORDS[name])) as f:
                rec = json.load(f)
            dry[name] = {"roofline": rec["roofline"],
                         "collective_bytes": rec["collective_bytes"],
                         "trace_s": rec["compile_s"],
                         "wall_s": time.perf_counter() - start}
            if "n_collective_permute" in rec:
                dry[name]["n_collective_permute"] = \
                    rec["n_collective_permute"]
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    rec = {"world1_nccl": {"train": train, "prefill": prefill},
           "gloo_ranks_on_the_card": ranks, "dryrun": dry,
           "card": smi_line, "phase_s": time.perf_counter() - t0}
    print(f"[dist] (a) NCCL world 1, (1, 1) mesh: train {train['config']}: "
          f"losses {train['losses_mesh']} vs unsharded "
          f"{train['losses_unsharded']}, params max|err| "
          f"{train['param_max_abs_err']:.3e}, bit-identical "
          f"{train['bit_identical']}, step ms {train['step_ms_mesh']} vs "
          f"{train['step_ms_unsharded']}; prefill {prefill['config']}: K2 "
          f"{prefill['k2_launches']} launches (bf16 route "
          f"{prefill['k2_launches_bf16']}), logits vs unsharded plain max|err| "
          f"{prefill['logits_max_abs_err']:.3e} (max |logit| "
          f"{prefill['max_abs_logit']:.1f}), {prefill['prefill_ms_mesh']:.1f} "
          f"ms vs {prefill['prefill_ms_unsharded_plain']:.1f} ms plain")
    m, g = ranks["moe"], ranks["gpipe"]
    print(f"[dist] (b) {DIST_RANKS} gloo ranks on the card: EP {m['config']}:"
          f" max|err| {m['max_abs_err']:.3e} (max |value| "
          f"{m['max_abs_value']:.1f}), tokens changing experts per layer "
          f"{m['tokens_changing_experts_per_layer']}, EP {m['ep_ms']:.1f} ms "
          f"vs local {m['local_ms']:.1f} ms; GPipe {g['config']}: output "
          f"max|err| {g['output_max_abs_err']:.3e}, gradients "
          f"{g['grad_max_abs_err']:.3e}, {g['gpipe_ms']:.1f} ms vs "
          f"{g['sequential_ms']:.1f} ms in order")
    for name, d in dry.items():
        r = d["roofline"]
        print(f"[dist] (c) dry-run {name}: compute {r['compute_s']:.4e} s, "
              f"memory {r['memory_s']:.4e} s, collective "
              f"{r['collective_s']:.4e} s, bound {r['bottleneck']}; "
              f"collective bytes {d['collective_bytes']}"
              + (f", {d['n_collective_permute']} collective-permutes"
                 if "n_collective_permute" in d else "")
              + f"; trace {d['trace_s']:.1f} s, wall {d['wall_s']:.1f} s")
    print(json.dumps({"dist": rec}))
    return prefill["k2_launches"]


def _smi():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _timed(spent, name, fn, *args):
    """fn(*args), its seconds added to ``spent[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    spent[name] = round(spent.get(name, 0.0) + time.perf_counter() - t0, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim-cpu-worker", default=None, metavar="NPZ",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sim-cycles", default=f"{SIM_WARMUP},{SIM_CYCLES}",
                    help=argparse.SUPPRESS)
    ap.add_argument("--baseline-src", default=None, metavar="DIR",
                    help="a directory holding earlier kernels under "
                         "src/repro_torch/csrc: the CUDA-core mlstm_scan.cu "
                         "(K3), flash_attention.cu (K2's f32 route) and "
                         "paged_attention.cu (K1) and commit 076818b's "
                         "four *_sm90.cu sources (its K3 is commit "
                         "774e907's, before the cluster outputs pass), "
                         "each timed beside the kernel that took its place "
                         "(benchmarks_torch/baselines.py)")
    args = ap.parse_args(argv)
    if args.sim_cpu_worker:
        sim_cpu_worker(args.sim_cpu_worker,
                       *map(int, args.sim_cycles.split(",")))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    spent = {}
    _timed(spent, "build", phase_build)
    baseline = {}
    if args.baseline_src:
        from benchmarks_torch import baselines
        baseline = _timed(spent, "baselines", baselines.load,
                          args.baseline_src)
        print(f"[build] baselines from {args.baseline_src}: "
              f"{sorted(baseline)}")
    rec_pa = _timed(spent, "K1", phase_kernels, baseline)
    rec_fa = _timed(spent, "K2", phase_flash_kernels, baseline)
    rec_ml = _timed(spent, "K3", phase_mlstm_kernels, baseline)
    _timed(spent, "small", phase_small_input)
    _timed(spent, "small", phase_small_forward)
    _timed(spent, "small", phase_small_xlstm)
    serve_launches, params = _timed(spent, "serve", phase_serve)
    # K1's main paths: the serve phase (the register route) and phase (j)
    # (the public wrapper at PAGED_GROUP_SHAPES, the mma route's)
    rec_pa["routes"]["registers"]["launches"] += serve_launches
    rec_pa["launches"] = sum(r["launches"] for r in rec_pa["routes"].values())
    rec_fa["launches"] = rec_fa["routes"]["bf16"]["launches"] = \
        _timed(spent, "forward", phase_forward, params, rec_fa["ms"],
               torch.bfloat16)
    # the f16 and f32 routes' main paths: the same model's float16 and
    # float32 forwards
    f16 = rec_fa["routes"]["f16"]
    f16["launches"] = f16["forward_launches"] = _timed(
        spent, "forward", phase_forward, params, f16["ms"], torch.float16)
    f32 = rec_fa["routes"]["f32"]
    f32["launches"] = f32["forward_launches"] = _timed(
        spent, "forward", phase_forward, params, f32["ms"], torch.float32)
    rec_fa["launches"] += f16["launches"] + f32["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bench = _timed(spent, "kernel_bench", phase_kernel_bench)
    # K3's main path is the kernel bench; the model path runs it 0 times
    rec_ml["launches"] = bench["mlstm_scan"]
    # K2's f32 route runs on the kernel bench too (all its flash calls)
    rec_fa["launches"] += bench["flash_attention"]
    f32["launches"] += bench["flash_attention"]
    rec_ml["model_path_launches"] = _timed(spent, "xlstm", phase_xlstm)
    _timed(spent, "train", phase_train)
    fam_launches, fam = _timed(spent, "families", phase_families)
    # K2's main paths: the Qwen forward and the families (moonshot's bf16
    # forwards, whisper's launch before its refusal; the reduced configs on
    # the f32 route)
    rec_fa["launches"] += fam_launches["bf16"] + fam_launches["f32"]
    rec_fa["routes"]["bf16"]["launches"] += fam_launches["bf16"]
    f32["launches"] += fam_launches["f32"]
    rec_fa["families"] = {"launches": fam_launches,
                          "moonshot_shape": fam["k2_moonshot_shape"],
                          "moonshot_k2_per_forward":
                              fam["moonshot"]["k2_per_forward"]}
    for rec in (rec_pa, rec_fa, rec_ml):
        rec["kernel_bench_launches"] = bench[rec["name"]]
    smi_line = _smi()
    # K2's main path in the distribution phase: the sharded prefill
    dist_launches = _timed(spent, "dist", phase_dist, smi_line)
    rec_fa["launches"] += dist_launches
    rec_fa["routes"]["bf16"]["launches"] += dist_launches
    rec_fa["dist_launches"] = dist_launches
    _timed(spent, "sim", phase_sim, smi_line)
    print(f"[chip_smoke] seconds by phase {json.dumps(spent)}")
    print(f"[chip_smoke] wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [rec_pa, rec_fa, rec_ml]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
