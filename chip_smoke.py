#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fedtpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR   # also torch.profiler tables in DIR
    python3 chip_smoke.py --only zoo      # the device and build phases, then phases 12 to 14
    python3 chip_smoke.py --only kernels  # the device and build phases, then K1's part of phase 3
    python3 chip_smoke.py --only sim      # the device and build phases, then phase 15's sim parts
    python3 chip_smoke.py --only disaster # the device and build phases, then phase 15's drills
    python3 chip_smoke.py --only async    # the device phase, then phase 16
    python3 chip_smoke.py --only obs      # the device and build phases, then phase 17
    python3 chip_smoke.py --only trace    # the device and build phases, then phase 18

Phases, each of which raises on failure (exit code not 0, no result line):

1. device: a CUDA card is required; its name and power limit as
   ``nvidia-smi`` reports them; TF32 off for the parity phases.
2. build: ``nvcc`` builds every kernel from ``fedtpu_torch/csrc``.
3. kernels: the grouped K1 and K2 against their plain PyTorch versions
   over each per-leaf round's leaves as one call (smallcnn's 8,
   MobileNet's 83, ResNet-18's 62 at 100 classes, densenet_cifar's 362,
   ShuffleNetV2's 170, MobileNetV2's 173, EfficientNet-B0's 210,
   RegNetY-400MF's 303 and PNASNet-B's 251 leaves x 64 clients: K1 in 1,
   2, 1, 5, 3, 3, 3, 4 and 4 launches, K2 in 1, 1, 1, 5, 2, 2, 3, 4 and
   3), ragged and
   empty leaves, views off 16-byte alignment and 200
   leaves (one launch per table of leaves), K1 also a leaf of 70,000 rows
   and both flat rows (one launch each); timed in turns at the small
   models as one call a round, one launch a leaf, (K2)
   torch.fake_quantize_per_channel_affine one call a leaf and a device
   copy of the same bytes, at the zoo's as one call; K3 forward and
   inverse at the rotq row [64, 2^20], MobileNet's [64, 2^22], [8, 2^22],
   ResNet-18's [64, 2^24], ShuffleNetV2's [64, 2^21], EfficientNet-B0's
   [32, 2^22] and widths and row counts
   around its phase boundary and lag, with -0.0, zeros and large
   magnitudes. Outputs must be bit-equal, and K3's inverse(forward(y))
   within 1e-5 of y. Kernel and plain version are timed with CUDA events,
   beside the bound that the card's memory rate sets; K3 also beside a
   device copy of the same bytes, one kernel pass, and its two phases with
   no reuse of the intermediate in L2.
4. reference: small rounds (4 clients) on the card against the same rounds
   on the CPU, where the wrappers run their plain versions: per leaf for
   none/topk/int8, flat for topk/int8/rotq/randk with the same injected
   draws on both sides.
5. slice: the bench configuration at full width (smallcnn, CIFAR-10 shapes,
   64 clients, batch 128, 6 local steps, iid, presharded, bf16) for 2
   rounds each of per-leaf topk and int8 and flat rotq, topk and int8, the
   launch counts reset just before and read after, each round's launches
   checked per codec, round 1's codec re-applied with the plain kernels;
   then timed rounds of every codec and layout, and the flat pack's cost.
6. mobilenet: the JAX package's flagship round (MobileNet at its published
   widths and full depth, P = 3,217,226 in 83 leaves, the same data,
   clients, steps, batch and dtype): a small MobileNet round on the card
   against the same round on the CPU, both with the global model in f64,
   per leaf none and flat rotq;
   then 2 rounds each of per-leaf none, topk and int8 and flat topk and
   rotq with the counts reset before and read after (2 K1, 1 K2, 1 K1,
   2 K3 a round, 0 of the others), round 1's codec re-applied with the
   plain kernels, finite losses and BatchNorm statistics; one gather-layout
   round and one server-adam round; timed rounds of every case, with the
   peak device memory.
7. options reference: the round options (median, trimmed mean, Krum, DP
   with the noise drawn once on the CPU, screening against a boosted
   sign-flipping attacker, FedProx on a Dirichlet assignment, megabatch,
   bf16 momentum) in small rounds (4 smallcnn clients, f32) on the card
   against the same rounds on the CPU: params within the reference
   tolerance, Krum's chosen client and the screened rows equal.
8. options: the round options at MobileNet's full width (64 clients, batch
   128, 6 steps, bf16): (a) Dirichlet(0.5) on the gather layout, FedProx,
   loss-sampled half participation and per-leaf int8 (1 K2 a round); (b)
   the same with flat top-k, screening and 8 boosted sign-flipping
   attackers (1 K1 a round); (c) the same with flat rotq (2 K3 a round);
   (d) median, trimmed mean and Krum, and DP on smallcnn at full width (DP
   refuses a model with BatchNorm, as fedtpu does), no kernel; (e)
   megabatch k=4, bf16 momentum and remat, beside the plain uncompressed
   rounds of both models. Each engine is built, driven two rounds and
   freed in turn, one turn over the cases; the launch counts are set to
   0 before the phase, checked every round and read after it; every
   round's losses and state must be finite. Then one local step with and
   without remat, for the memory its forward holds and its peak.
9. edge: the port's gRPC client (``LocalTrainer``) and the coordinator's
   math, with neither grpc nor msgpack. First a small smallcnn
   ``train_round`` (f32) on the card against the same call on the CPU, per
   codec and layout of the reference phase, replies held within its
   tolerance. Then at
   MobileNet's full width: 4 trainers (ranks 0-3 of 64, 256 examples, 2
   steps of batch 128, bf16: the host paths' local work, cut from 6) on
   one copy of the data, per leaf (none, topk, int8) and flat (topk,
   int8, rotq, randk), a dense round 0 and a round a
   codec after the global model lands as FTP1 bytes; every reply decoded
   into a [64, P] f32 buffer on the card (P = 3,239,114: params and
   BatchNorm statistics, as fedtpu's edge row; rows 4-63 copies of 0-3)
   and checked against its delta within the codec's own error;
   finalize_stream and aggregate (mean, median, trimmed mean, Krum) on the
   buffer, timed, and on its 4 distinct rows held against the CPU (Krum's
   choice equal). The train_round split (update on the card, copy to the
   host, host encode), reply bytes, host decode, server ms and peak memory
   are printed beside the card. The edge launches none of K1-K3: the
   counts are set to 0 before it and must read 0 after.
10. federation: the coordinator over localhost gRPC (its only phase that
   imports grpc): a port PrimaryServer and BackupServer and 4 port
   serve_client MobileNet clients (2 steps of batch 128, bf16), all on the
   card. A dense round 0, then a round each of per-leaf none and topk
   (barrier) and flat rotq and int8 (stream), each group a primary started
   from the last one's replica and clients of the group's codec; a round
   whose deadline holds one client back (a live straggler); then the
   failover drill: the primary stops, the backup promotes on its 2 s
   watchdog and commits one round, and a restarted primary demotes it,
   fetches its state and runs on, the round counter continuous. Every
   round's global is held against the CPU's combine of the replies it
   used (atol=1e-5, rtol=1e-4, all but 0.1% of coordinates),
   ``bytes_down`` against the payloads, and every client's installed model
   against the primary's. Each primary's registry and flight ring against
   its records: the rounds counter its committed rounds,
   ``fedtpu_rpc_bytes_up_total`` the sum of their ``bytes_up`` exactly, a
   phase histogram count a round, a flight ``round`` event a round; the
   backup's flight recorder (a temporary directory, its path logged) dumps
   on the promotion with a ``failover:`` reason. Each round's split
   (collect, decode, h2d, aggregate, post-barrier), bytes and wall time,
   the time to recover and the peak memory are printed beside the card;
   K1-K3 are launched 0 times. The per-leaf topk group runs its primary
   and its clients under ``telemetry='trace'``: every client's tracer ends
   with the primary's ``trace_id``, its ``client_train`` spans name the
   primary as their remote parent, and each process's export (a temporary
   directory) merges under ``tools/trace_merge.py --check``, run as a
   subprocess, with every client's ``client_train`` under a ``client_rpc``
   and rooted at a ``round`` in the primary's lane.
   ``--only federation`` runs the device phase and this one alone.
11. faults: the rest of the coordinator over localhost gRPC, 4 port
   MobileNet clients as in phase 10 (flat int8, stream). (a) chaos: a
   primary and backup, the primary armed with seeded StartTrain errors and
   corruptions and SendModel delays, one client's server with SendModel
   errors, one client a sign-flipping attacker; 3 rounds, each with all 4
   clients, every injected fault retried once, the attacker's row the
   negation of its honest delta within int8's error. (b) the membership
   gate: a fifth client joins, is resynced and trains the next round,
   then leaves; the backup answers Join "not primary". (c) the adaptive
   codec policy: 6 rounds, the first 5 warming every client through none,
   int8, topk, rotq and randk, the sixth the cheapest. (d) two tiers: a
   root with ``tier_fanout=2`` and two AggregatorServers that join its
   gate, each fronting 2 clients, 2 rounds; then one aggregator stops and
   the root, at quorum 0.5, masks its row. Every round's global is held
   against the CPU's combine of the client replies it used (the flat mean
   of all 4 for the tiers); K1-K3 are launched 0 times.
   ``--only faults`` runs the device phase and this one alone.

12. zoo: (a) small rounds of the zoo's families on the card against the
   same rounds on the CPU: MLP on MNIST shapes (BASELINE config 1: 2
   clients, iid) and LeNet in f32; VGG11, ResNet-18 (per leaf none and
   flat rotq), PreActResNet18 and densenet_cifar with
   the global model in f64 (4 clients, batch 4, one step masked), each
   within the reference tolerance. (b) BASELINE config 4 at full width:
   ResNet-18 at 100 classes on CIFAR-100 shapes (the synthetic fallback,
   50,000 examples), 64 clients, batch 128, 6 local steps, iid, bf16, lr
   0.05 constant, augmentation: a round of per-leaf none and 2 each of
   topk, int8 and flat rotq with the counts set to 0 before and read after (1
   K1, 1 K2, 2 K3 a round, 0 of the others), round 1's codec re-applied
   with the plain kernels, finite losses and statistics; the uncompressed
   round timed (rounds/s, client-epochs/s, MFU against the bf16 peak) and
   profiled (the device's idle share), a remat round for its memory, and
   a round of ZOO_EPOCHS (2) local epochs (config 4's local work is 5; cut
   for the script's time), with peak memory; the uncompressed case runs one
   checked round (it has no codec to re-apply), then its timed one.
   (c) densenet_cifar per-leaf topk and int8, 2 rounds each, at 8 clients
   (its activations at 64 do not fit the card; fedtpu's DenseNet has no
   remat): 5 K1 and 5 K2 a round. ``--only zoo`` runs the device and
   build phases, this one and phase 13.
13. zoo, part 2a: (a) a small round of each family of the zoo's second
   part on the card against the same round on the CPU, the global model in
   f64 (4 clients, batch 4, one step masked): MobileNetV2, ShuffleNetG3
   and ShuffleNetV2 at 16x16, GoogLeNet, ResNeXt29_2x64d, SENet18 and
   DPN26 at 8x8, per leaf none, and topk for DPN26. (b)
   ShuffleNetV2 at full width on the flagship round's traffic (CIFAR-10
   shapes, 64 clients, batch 128, 6 local steps, iid, presharded, bf16):
   first a round at 8 clients for its peak, scaled to 64; then a round of
   per-leaf none and 2 each of per-leaf topk (3 K1 a round) and int8 (2
   K2) and flat rotq (2 K3 over [64, 2^21]) with the counts set to 0 before and read
   after, round 1's codec re-applied with the plain kernels, finite losses
   and statistics; the uncompressed round timed (rounds/s,
   client-epochs/s, MFU against the bf16 peak) and profiled (the device's
   idle share), with peak memory. (c) MobileNetV2 at 16 clients (its
   activations at 64 would need twice the card; its 8-client peak is
   printed first): 2 rounds each of per-leaf topk (3 K1) and int8 (2 K2).
14. zoo, part 2b: (a) a small round of every name of the zoo's last part
   on the card against the same round on the CPU, the global model in f64
   (4 clients, batch 4, one local step, client 1's masked), after its f64 logits
   and gradient under vmap (2 clients) within 1e-10 of the CPU's, per
   leaf none: EfficientNet-B0
   at 32x32 (both devices fed the same keep masks for its drop-connect
   and dropout), DLA and SimpleDLA at 16x16, the RegNets and PNASNets at
   8x8; and per-leaf topk for RegNetY-400MF. (b)
   EfficientNet-B0 at full width on the flagship round's traffic, its
   drop-connect and dropout drawn on the card from the round's seeded
   generator: first a round at 8 clients for its peak, scaled linearly to
   pick the clients (64 if under 75 GB there, else 32, else 16); then 2
   rounds each of per-leaf none, topk (3 K1 a round) and int8 (3 K2) and
   flat rotq (2 K3 over [clients, 2^22]) with the counts set to 0 before
   and read after, round 1's codec re-applied with the plain kernels,
   finite losses and statistics, and the share of examples the drawn
   masks keep in the last drop-connect block (0.825 +- 0.02) and of the
   head's entries (0.8 +- 0.02); the uncompressed round timed (rounds/s,
   client-epochs/s, MFU against the bf16 peak) and profiled (the device's
   idle share), with peak memory.
15. the sim engine and disaster recovery: (ref) a small sim round on the
   card against the same round on the CPU (smallcnn, a population of 256
   through 4 seats, per-leaf topk, 2 rounds with reassigned seats, the same
   numpy gather keys on both devices). (a) ``docs/SIMULATION.md``'s
   deployment: MobileNet at full width, a population of 10,000 through 64
   seats, scenario ``dirichlet:alpha=0.1+quantity_skew:power=1.5``, on the
   flagship round's traffic (gather layout): 3 rounds each of per-leaf
   topk (2 K1 a round) and int8 (1 K2) through step(), a new cohort each
   round, every reassigned seat's momentum and residual checked reset
   before it trains, the population's tables advancing 64 draws a round,
   round 1's codec re-applied with the plain kernels; one run_on_device(2)
   block (one cohort, 2 K2); the warm round timed, the peak memory, and
   the per-seat state bytes, equal at populations 10,000 and 5,000. (b)
   engine resume: bench.py's smallcnn round (64 clients, per-leaf topk with
   error feedback) saving every round through a BackgroundCheckpointer
   (keep 3), generation 3 rotted by ckpt_rot; after round 3 the engine is
   dropped, a new one restores generation 2 and runs rounds 3-4, bit-equal
   to a control that never stopped (rounds under deterministic algorithms;
   an op torch names as having none makes it a tolerance check naming it);
   1 K1 a round. Its three steps run around (a) and (c), so the writer
   compresses beside them. (c) the coordinator's cold restart over
   localhost gRPC: 4 port MobileNet clients (2 steps, flat int8, stream,
   server momentum), each with a state_dir; a control of 3 rounds; a
   primary saving every round, its newest generation rotted, stopped after
   round 1; a new primary restores generation 0, re-runs round 1 through
   the clients' rollback and runs round 2: the lineage continuous, the
   roster and the server momentum restored, the global within phase 10's
   tolerance of the control's, the time to recover printed; no K1-K3.
16. the asynchronous engine, run_async and the solo trainer: (ref) small
   checks on the card against the CPU: 3 ticks of smallcnn at 4 clients
   (batch 8, 2 steps, buffer 2, speed_sigma 0.7), 3 tick() calls against
   one run_on_device(3) under deterministic algorithms, a buffer_k ==
   num_clients tick against the synchronous round, 4 solo steps. (a) the
   JAX package's async_fused10 program (tools/compile_pallas_tpu.py):
   smallcnn at bench.py's traffic, FedBuff at buffer 2, staleness power
   0.5, damping, speed_sigma 1.0; a run_on_device(10) block cold, then one
   warm and timed: ticks/s, the clients that trained each tick (all 64 are
   computed), staleness, peak memory; 2 arrivals a tick, versions 10 and
   20, no client pending that just arrived, finite state. (b) MobileNet at
   full width on the flagship traffic, the same FedBuff settings: 2 tick()
   calls and one run_on_device(2), the warm tick timed, peak memory and
   the async state's bytes. (c) PrimaryServer.run_async over localhost
   gRPC: 4 port MobileNet clients (2 steps, bf16), the last slowed, buffer
   2, 8 updates: updates/s, each update's contributors and staleness; each
   update's global within phase 10's tolerance of the CPU's FedBuff apply
   of the same buffer, the fast clients carrying more updates than the
   slow one, the final sync reaching every client. (d) SoloTrainer,
   MobileNet at full width (batch 128, eval batch 100, lr 0.1, momentum
   0.9, weight decay 5e-4): one epoch of 384 steps and a test epoch that
   writes the checkpoint, a fresh trainer resumed from it bit-equal:
   steps/s, examples/s, peak memory. No K1-K3 launch on these paths.
17. obs: the observability plane on phase 6's MobileNet per-leaf topk
   engine (64 clients, batch 128, 6 steps, bf16), run between phase 6's
   timing and its options: an ObsServer on 127.0.0.1 serves its registry,
   status snapshot and a flight recorder while a thread scrapes
   ``/metrics``, ``/statusz``, ``/healthz`` and ``/flightz`` every 50 ms;
   2 rounds under ``telemetry='basic'`` (K1 twice a round, counted from
   0), then 2 with ``Telemetry("off")`` swapped in. Every scrape answers
   200 and parses, the rounds counter equals the rounds stepped since the
   engine was built, ``/statusz`` ends at that round, idle, all 64 alive.
   Rounds/s under both modes and the ``/metrics`` scrape latency (p50,
   max) are printed; no speed is asserted.
18. trace: the span tracer on the same engine, right after phase 17:
   ``Telemetry("trace", role="engine")`` swapped in, its spans fed to a
   flight recorder. 2 rounds through ``step()`` under ``torch.profiler``
   (host and device), K1's launches counted from 0: one ``round`` span a
   round carrying the engine's round number, K1 4 times and K2/K3 never,
   one ``record_function`` range named ``round`` a round in the profile,
   each of K1's 4 host launches inside one of them (2 in each, matched to
   the kernel's device executions by the runtime's correlation id). The
   flight ring holds the spans; ``export_trace`` (a temporary directory,
   its path logged) loads back with its metadata; ``/statusz`` names the
   tracer's ``trace_id``; one ``run_on_device(2)`` block is one
   ``fused_rounds`` span. Rounds/s under trace (2 rounds, outside the
   profiler), spans and exported bytes a round are printed beside phase
   17's ``basic`` rounds/s; no speed is asserted.

The last line is ``{"ok": true, "device": {...}}``; the line with the
kernels' numbers and the card's name and power limit come just before it.
Each kernel's ``launches`` there is the sum over the main paths, the
smallcnn slice, the MobileNet round, the round options, the zoo and the
zoo's second and last parts (``zoo2``, ``zoo3``), the sim engine
(``sim``: K1 and K2), the engine drill (``disaster``: K1), the async
engine with run_async (``async``: none), the solo trainer (``solo``:
none), the observability plane (``obs``: K1) and the span tracer
(``trace``: K1); ``launches_by_path`` has each.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

# The MobileNet round fills most of the card; segments that grow keep the
# caching allocator from fragmenting it. Read at the first allocation.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# cuBLAS's fixed workspace, which deterministic algorithms need (phase 15's
# engine resume). Read when cuBLAS starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fedtpu_torch import DataConfig, FedConfig, Federation, OptimizerConfig, RoundConfig, models  # noqa: E402
from fedtpu_torch.config import RetryPolicy, ScreenConfig, SimConfig  # noqa: E402
from fedtpu_torch.core import round as round_lib  # noqa: E402
from fedtpu_torch.core.round import RoundDraws, init_state  # noqa: E402
from fedtpu_torch.data import datasets  # noqa: E402
from fedtpu_torch.models.common import draw_masks, mask_specs  # noqa: E402
from fedtpu_torch.ops import compression, flat, kernels  # noqa: E402
from fedtpu_torch.transport import aggregation as edge_aggregation  # noqa: E402
from fedtpu_torch.transport import msgpack as _msgpack  # noqa: E402
from fedtpu_torch.transport import sparse, wire  # noqa: E402
from fedtpu_torch.transport.trainer import LocalTrainer  # noqa: E402
from fedtpu_torch.obs import process_rss_bytes  # noqa: E402

NUM_CLIENTS = 64
BATCH = 128
STEPS = 391 // NUM_CLIENTS  # the reference's local-epoch share at 64 clients
CHECK_ROUNDS = 2  # round 0, and round 1 whose codec is re-applied with the plain kernels
TIMED_ROUNDS = 2  # warm rounds a timed smallcnn case: the script stays under 900 s with phase 16
TIMING_REPEATS = 1  # turns over the timed cases: one keeps the whole run well inside its limit
LEAF_TIMING_RUNS = 2  # runs of _time_ms a leaf where a form is timed leaf by leaf (5 before phase 16)
TOPK_FRACTION = 0.01

# Published peaks (NVIDIA data sheets, dense, full power): HBM bytes/s and
# f32 FLOP/s outside the tensor cores, by the name torch reports.
CARDS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),   # H100 SXM
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
)

# Per kernel: the TPU kernel it replaces, its source, bytes moved per
# element and per row, and f32 operations per element.
KERNEL_INFO = {
    "threshold_feedback": dict(
        replaces="fedtpu/ops/pallas_kernels.py:108",
        tpu_function="threshold_with_feedback",
        source="fedtpu_torch/csrc/threshold_feedback.cu", codec="topk",
        bytes_per_elem=12, bytes_per_row=4, ops_per_elem=3,
    ),
    "quantdequant_int8": dict(
        replaces="fedtpu/ops/pallas_kernels.py:233",
        tpu_function="quantdequant_int8",
        source="fedtpu_torch/csrc/quantdequant_int8.cu", codec="int8",
        bytes_per_elem=8, bytes_per_row=4, ops_per_elem=5,
    ),
    "hadamard_rotate": dict(
        replaces="fedtpu/ops/pallas_kernels.py:179",
        tpu_function="hadamard_rotate",
        source="fedtpu_torch/csrc/hadamard_rotate.cu",
    ),
}

# K3's shapes: the smallcnn rotq round's row first (timed), then the
# MobileNet rotq round's [64, 2^22] and an [8, 2^22] (both timed), the
# smallest width, widths around the
# kernel's 2^13-element tile (the widest one-phase row, the narrowest
# two-phase one), row counts that are not a multiple of the lag between its
# phases, and a 2^21 row. The same list as tests/test_torch_cuda.py.
HADAMARD_SHAPES = [
    (64, 2**20), (64, 2**22), (8, 2**22), (3, 128), (1, 2**12), (5, 2**13),
    (64, 2**14), (3, 2**20), (65, 2**14), (1, 2**13), (2, 2**21),
]
# The ResNet-18 rotq round's row: 11,229,732 params and statistics padded
# to 2^24 (4 GiB a buffer at 64 clients), checked and timed in the kernels
# phase beside the list above.
ZOO_HADAMARD_SHAPE = (64, 2**24)
FLAT_P = 545_152  # smallcnn's lane-padded flat row
MOBILENET_FLAT_P = 3_217_280  # MobileNet's: P = 3,217,226 lane-padded
MOBILENET_LEAVES = 83
MOBILENET_TIMED_ROUNDS = 1  # a warm round after the checked ones: the script stays under 900 s with phase 15
# The zoo's per-leaf shapes: ResNet-18 at 100 classes, densenet_cifar,
# ShuffleNetV2 and MobileNetV2 at 10.
RESNET18_LEAVES = 62
DENSENET_LEAVES = 362
SHUFFLENETV2_LEAVES = 170
MOBILENETV2_LEAVES = 173
ZOO_TIMING_RUNS = 1  # runs of _time_ms a leaf: the zoo has 767 leaves to time
# The ShuffleNetV2 rotq round's row: 1,263,854 params and 16,180 statistics
# padded to 2^21, checked and timed beside ZOO_HADAMARD_SHAPE.
ZOO2_HADAMARD_SHAPE = (64, 2**21)
# The zoo's last part: EfficientNet-B0 (the full-width round), RegNetY-400MF
# and PNASNet-B (the most leaves) at 10 classes; EfficientNet's rotq row,
# 3,598,598 params and 39,456 statistics padded to 2^22, at the 32 clients
# its memory probe picks on an 80 GB card (phase 14 re-applies the plain
# K3 at whatever count it runs).
EFFICIENTNET_LEAVES = 210
REGNETY_LEAVES = 303
PNASNETB_LEAVES = 251
ZOO3_HADAMARD_SHAPE = (32, 2**22)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, led by the seconds since the script
    started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


# ------------------------------------------------------------- 1. device


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    for key, bw, f32 in CARDS:
        if key in name:
            peaks = (bw, f32)
            break
    else:
        raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(
        f"device: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}"
    )
    return smi, name, peaks


# -------------------------------------------------------------- 2. build


def build_phase():
    t0 = time.perf_counter()
    logs = kernels.build()
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.strip().splitlines():
            log(f"build {name}: {line.strip()}")
    for name in kernels.KERNELS:
        if not kernels.library_path(name).exists():
            raise RuntimeError(f"build: {name} has no library")
    log(f"build: {len(kernels.KERNELS)} kernels in {secs:.2f} s")


# ------------------------------------------------------------ 3. kernels


LEAVES = {"mobilenet": MOBILENET_LEAVES, "resnet18": RESNET18_LEAVES, "densenet_cifar": DENSENET_LEAVES,
          "shufflenetv2": SHUFFLENETV2_LEAVES, "mobilenetv2": MOBILENETV2_LEAVES,
          "efficientnetb0": EFFICIENTNET_LEAVES, "regnety_400mf": REGNETY_LEAVES, "pnasnetb": PNASNETB_LEAVES}


def per_leaf_shapes(model_name: str, classes: int = 10):
    """``[clients, leaf size]`` of every leaf of a model, as a per-leaf
    codec sees them."""
    with torch.device("meta"):
        model = models.create(model_name, classes)
    shapes = [(NUM_CLIENTS, p.numel()) for p in model.parameters()]
    if len(shapes) != LEAVES.get(model_name, len(shapes)):
        raise RuntimeError(f"kernels: {model_name} has {len(shapes)} leaves")
    return shapes


# Ragged (rows, cols) beside the rounds' shapes.
RAGGED = [(1, 1), (1, 700), (3, 257), (2, 1), (64, 1000), (5, 65537)]


def _inputs(name, g, rows, cols, dev):
    """The operands at one shape, drawn on the card from the generator
    ``g`` (the zoo's rounds are over a billion draws), with the edge cases
    the tests use: a -0.0, a threshold tied with a value, an all-zero row
    of scale 0, and quotients exactly halfway between integers."""
    x = torch.randn((rows, cols), generator=g, device=dev)
    x[0, 0] = -0.0
    if name == "threshold_feedback":
        v = x[:, min(1, cols - 1)].abs()
        v[1::2] = 0.5
        if rows > 2:
            v[2] = 0.0
    else:
        v = x.abs().amax(dim=1) / 127.0
        if rows > 1:
            x[1] = (torch.randint(-130, 130, (cols,), generator=g, device=dev) + 0.5) * 0.25
            v[1] = 0.25
        if rows > 2:
            x[2] = 0.0
            v[2] = 0.0
    return x, v


def _bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _time_ms(fn, runs=21, calls=10, own_syncs=False) -> float:
    """Device time of one call, in ms: the median over ``runs`` of
    ``calls`` calls enqueued back to back between two CUDA events, divided
    by ``calls``. Each run is queued behind a device-side sleep that must
    still be running when the host has enqueued the run's last call (else
    the run is dropped and the sleep doubled), so the events time the
    card's work and never a card waiting for the host. A call that
    synchronizes with the card itself (``own_syncs``) cannot be enqueued
    ahead: its time includes the card's waits for it. A run of many
    launches can fill the card's queue of pending launches, which makes
    the host wait too: keep ``calls`` times the launches a call under a
    hundred or so."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sleep = 4_000_000  # cycles, ~2 ms
    pairs = []
    while len(pairs) < runs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_s = time.perf_counter() - t0
        b.record()
        if not own_syncs and a.query():  # the card was past its sleep before the host was done
            torch.cuda.synchronize()
            sleep *= 2
            if sleep > 1 << 34:
                raise RuntimeError(
                    f"timing: the card finished a {sleep // 2}-cycle sleep before the host "
                    f"had enqueued {calls} calls (the last enqueue took {host_s * 1e3:.2f} ms)"
                )
            continue
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / calls for a, b in pairs)


def _bound(bytes_moved, ops, peaks):
    """(bound in ms, what bounds it): the larger of bytes over the memory
    rate and f32 operations over the f32 rate."""
    bw, f32_peak = peaks
    by_bytes, by_ops = bytes_moved / bw * 1e3, ops / f32_peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


# The grouped kernels: (grouped wrapper, its plain version leaf by leaf,
# leaves a launch).
GROUPED = {
    "threshold_feedback": (kernels.threshold_feedback_grouped, kernels.threshold_feedback_grouped_plain,
                           kernels.THRESHOLD_GROUP_CAPACITY),
    "quantdequant_int8": (kernels.quantdequant_int8_grouped, kernels.quantdequant_int8_grouped_plain,
                          kernels.INT8_GROUP_CAPACITY),
}


def _launches(name, xs) -> int:
    """Launches of a grouped kernel over leaves ``xs``: one per table of
    non-empty leaves."""
    return -(-sum(x.numel() > 0 for x in xs) // GROUPED[name][2])


def _by_leaf(outs):
    """A grouped call's outputs as one tuple per leaf (K1 returns ``(outs,
    new_es)``, K2 ``outs``)."""
    return list(zip(*outs)) if isinstance(outs, tuple) else [(o,) for o in outs]


def _leaves(name, g, shapes, dev, misaligned=()):
    """A grouped kernel's operands at ``shapes`` (``_inputs``; zeros for an
    empty leaf), the leaves at ``misaligned`` as views one float past
    16-byte alignment."""
    xs, vs = [], []
    for i, (rows, cols) in enumerate(shapes):
        if rows * cols == 0:
            x, v = torch.zeros((rows, cols), device=dev), torch.zeros((rows,), device=dev)
        else:
            x, v = _inputs(name, g, rows, cols, dev)
        if i in misaligned:
            buf = torch.zeros(x.numel() + 1, device=dev)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(rows, cols)
        xs.append(x)
        vs.append(v)
    return xs, vs


def _check_group(name, label, xs, vs) -> float:
    """One grouped call bit-equal to the plain version leaf by leaf, in
    one launch per table of leaves."""
    grouped, plain, _ = GROUPED[name]
    wrapper = kernels.KERNELS[name][0]
    before = wrapper.launches
    got = _by_leaf(grouped(xs, vs))
    want = _by_leaf(plain(xs, vs))
    torch.cuda.synchronize()
    launches = wrapper.launches - before
    if launches != _launches(name, xs):
        raise RuntimeError(
            f"kernels: grouped {name} over {label} launched {launches} times, "
            f"expected {_launches(name, xs)}")
    err = 0.0
    for x, gs, ws in zip(xs, got, want):
        for g, w in zip(gs, ws):
            if not _bits_equal(g, w):
                raise RuntimeError(
                    f"kernels: grouped {name} differs from its plain version at {tuple(x.shape)} ({label})")
            if x.numel():
                err = max(err, float((g - w).abs().max()))
    return err


def _check_cases(name, g, dev, rounds, extra=None) -> float:
    """The grouped kernel bit-equal over each round's leaves, ragged
    leaves, a list that mixes empty, 1-, 10- and 65,537-column leaves,
    leaves passed as views one float past 16-byte alignment, 200 leaves
    (more than one launch's table) and ``extra``; returns the largest
    difference."""
    cases = {
        **rounds,
        "ragged": _leaves(name, g, RAGGED, dev),
        "mixed": _leaves(name, g, [(0, 5), (3, 0), (2, 1), (3, 10), (2, 65537), (1, 1), (5, 7)], dev),
        "misaligned": _leaves(
            name, g, [(3, 4099), (1, 2), (2, 65537), (4, 10), (64, 1000)], dev, misaligned=(0, 1, 2, 4)),
        "200 leaves": _leaves(name, g, [(2, 1 + i % 37) for i in range(200)], dev),
        **{label: _leaves(name, g, shapes, dev) for label, shapes in (extra or {}).items()},
    }
    max_err = max(_check_group(name, label, *leaves) for label, leaves in cases.items())
    log(f"kernels: {name} grouped bit-equal over {', '.join(cases)}")
    return max_err


def _round_bound(name, xs, peaks):
    """(bytes, bound in ms, what bounds it) of a kernel over leaves ``xs``."""
    info = KERNEL_INFO[name]
    bytes_moved = sum(x.numel() * info["bytes_per_elem"] + x.shape[0] * info["bytes_per_row"] for x in xs)
    ops = sum(x.numel() * info["ops_per_elem"] for x in xs)
    return (bytes_moved, *_bound(bytes_moved, ops, peaks))


def _host_ms(grouped, xs, vs) -> float:
    """The host's time to enqueue one grouped call, in ms (20 calls)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        grouped(xs, vs)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    return host_ms


def _leaf_by_leaf(fn, operands, own_syncs=False, runs=LEAF_TIMING_RUNS):
    """A form that times ``fn`` on each leaf's operands and sums."""
    return lambda: sum(_time_ms(lambda: fn(*ops), runs=runs, own_syncs=own_syncs) for ops in operands)


def _grouped_round(name, label, xs, vs, peaks, extra_forms=None):
    """A grouped kernel over one small model's per-leaf round, timed in
    turns (each form, then the same backwards): (a) the grouped call, (b)
    the same kernel one leaf a launch, ``extra_forms`` (K2: the library
    call one leaf a call) and a device copy of the same bytes as a
    yardstick; each beside the bytes bound. The forms that launch per leaf
    are timed leaf by leaf and summed (a run of 83 leaves' launches fills
    the card's queue of pending launches). Also the plain version's time
    leaf by leaf and the host's time to enqueue a grouped call."""
    grouped = GROUPED[name][0]
    one_leaf, plain = kernels.KERNELS[name]
    bytes_moved, bound_ms, bound_by = _round_bound(name, xs, peaks)
    # The copy reads and writes half the kernel's bytes per element each.
    elems = sum(x.numel() for x in xs) * KERNEL_INFO[name]["bytes_per_elem"] // 8
    copy_in = torch.empty(elems, device=xs[0].device)
    copy_out = torch.empty_like(copy_in)
    forms = {
        "grouped": lambda: _time_ms(lambda: grouped(xs, vs)),
        "per_leaf": _leaf_by_leaf(one_leaf, list(zip(xs, vs))),
        **(extra_forms or {}),
        "copy": lambda: _time_ms(lambda: copy_out.copy_(copy_in)),
    }
    turns = {k: [] for k in forms}
    for form in [*forms, *reversed(forms)]:
        turns[form].append(forms[form]())
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    out = {
        "leaves": len(xs), "ms": ms["grouped"], **{f"{k}_ms": v for k, v in ms.items() if k != "grouped"},
        "plain_ms": _leaf_by_leaf(plain, list(zip(xs, vs)))(), "turns_ms": turns,
        "host_ms_per_grouped_call": _host_ms(grouped, xs, vs),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
        **{f"{k}_share_of_bound": bound_ms / v for k, v in ms.items()},
        "implied_tb_per_s": bytes_moved / ms["grouped"] / 1e9,
        "launches_per_round": _launches(name, xs),
    }
    log(f"kernels: {name} over one {label} per-leaf round: " + json.dumps(out))
    return out


def _grouped_zoo_round(name, label, xs, vs, peaks):
    """A grouped kernel over a zoo model's per-leaf round (one launch per
    table of leaves), timed as one call, beside its bound, the plain
    version leaf by leaf (a run of hundreds of leaves' plain ops would fill
    the card's queue of pending launches) and the host's time to enqueue a
    grouped call."""
    grouped = GROUPED[name][0]
    ms = _time_ms(lambda: grouped(xs, vs))
    bytes_moved, bound_ms, bound_by = _round_bound(name, xs, peaks)
    out = {
        "leaves": len(xs), "ms": ms,
        "plain_ms": _leaf_by_leaf(kernels.KERNELS[name][1], list(zip(xs, vs)), runs=ZOO_TIMING_RUNS)(),
        "host_ms_per_grouped_call": _host_ms(grouped, xs, vs),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved, "share_of_bound": bound_ms / ms,
        "implied_tb_per_s": bytes_moved / ms / 1e9,
        "launches_per_round": _launches(name, xs),
    }
    log(f"kernels: {name} over one {label} per-leaf round: " + json.dumps(out))
    return out


def _grouped_phase(name, seed, peaks, extra_cases=None, round_forms=None):
    """A grouped kernel's phase: bit-equal over each per-leaf round's leaves
    as one call and the edge lists (``_check_cases``), then timed over each
    round's leaves (``round_forms(xs, vs)`` adds forms and numbers to the
    small models' turns). Returns the kernels line's entry."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(seed)
    rounds = {m: _leaves(name, g, per_leaf_shapes(m), dev) for m in ("smallcnn", "mobilenet")}
    zoo = {
        "resnet18": _leaves(name, g, per_leaf_shapes("resnet18", 100), dev),
        **{m: _leaves(name, g, per_leaf_shapes(m), dev)
           for m in ("densenet_cifar", "shufflenetv2", "mobilenetv2", "efficientnetb0", "regnety_400mf", "pnasnetb")},
    }
    max_err = _check_cases(name, g, dev, {**rounds, **zoo}, extra_cases)
    timed = {}
    for model, label in (("smallcnn", "smallcnn"), ("mobilenet", "MobileNet")):
        forms, more = round_forms(*rounds[model]) if round_forms else ({}, dict)
        timed[model] = _grouped_round(name, label, *rounds[model], peaks, forms)
        timed[model].update(more())
    for model, label in (("resnet18", "ResNet-18"), ("densenet_cifar", "densenet_cifar"),
                         ("shufflenetv2", "ShuffleNetV2"), ("mobilenetv2", "MobileNetV2"),
                         ("efficientnetb0", "EfficientNet-B0"), ("regnety_400mf", "RegNetY-400MF"),
                         ("pnasnetb", "PNASNet-B")):
        timed[model] = _grouped_zoo_round(name, label, *zoo[model], peaks)
    del zoo, rounds
    info = KERNEL_INFO[name]
    small = timed["smallcnn"]
    return {
        "name": name,
        "route": "cuda",
        "source": info["source"],
        "replaces": info["replaces"],
        "tpu_function": info["tpu_function"],
        "bitwise_equal": True,
        "max_abs_err": max_err,
        "ms": small["ms"],
        "kernel_ms": small["ms"],
        "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"],
        "bound_by": small["bound_by"],
        "bytes": small["bytes"],
        "library_ms": small.get("library_ms"),
        "per": f"one smallcnn per-leaf {info['codec']} round (eight leaves in one launch, {NUM_CLIENTS} clients)",
        "smallcnn_per_leaf_round": small,
        "mobilenet_per_leaf_round": timed["mobilenet"],
        "resnet18_per_leaf_round": timed["resnet18"],
        "densenet_per_leaf_round": timed["densenet_cifar"],
        "shufflenetv2_per_leaf_round": timed["shufflenetv2"],
        "mobilenetv2_per_leaf_round": timed["mobilenetv2"],
        "efficientnetb0_per_leaf_round": timed["efficientnetb0"],
        "regnety_400mf_per_leaf_round": timed["regnety_400mf"],
        "pnasnetb_per_leaf_round": timed["pnasnetb"],
    }


def kernel_phase(peaks):
    """K1, grouped: bit-equal to its plain version leaf by leaf as one call
    per round (smallcnn's 8 leaves in one launch, MobileNet's 83 in 2,
    ResNet-18's 62 in 1, densenet_cifar's 362 in 5, ShuffleNetV2's 170,
    MobileNetV2's 173 and EfficientNet-B0's 210 in 3, RegNetY-400MF's 303
    and PNASNet-B's 251 in 4) and over the edge lists
    and a leaf of 70,000 rows (past the 65,535 of a grid axis); timed over
    each round's leaves; then each flat row in one launch, bit-equal and
    timed. No single PyTorch call computes K1's two outputs: no library
    yardstick."""
    name = "threshold_feedback"
    result = _grouped_phase(name, 0, peaks, extra_cases={"70,000 rows": [(70_000, 3)]})
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    wrapper, plain = kernels.KERNELS[name]
    for model, cols in (("smallcnn", FLAT_P), ("mobilenet", MOBILENET_FLAT_P)):
        x, v = _inputs(name, g, NUM_CLIENTS, cols, dev)
        err = _check_group(name, f"the {model} flat row", [x], [v])
        bytes_moved, bound_ms, bound_by = _round_bound(name, [x], peaks)
        ms = _time_ms(lambda: wrapper(x, v))
        row = {"shape": [NUM_CLIENTS, cols], "ms": ms, "plain_ms": _time_ms(lambda: plain(x, v)),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
               "share_of_bound": bound_ms / ms, "launches_per_round": 1}
        result[f"{model}_flat_row"] = row
        result["max_abs_err"] = max(result["max_abs_err"], err)
        log(f"kernels: {name} over the {model} flat row: " + json.dumps(row))
    return result


def _fake_quantize(x, safe, zero_point):
    """The library yardstick on one leaf: ``torch.fake_quantize_per_channel_affine``
    with K2's safe scale (``s > 0 ? s : 1``) and zero point 0. It multiplies
    by ``1 / s`` where K2 divides, and reads its zero points' range back to
    the host before it launches."""
    return torch.fake_quantize_per_channel_affine(x, safe, zero_point, 0, -127, 127)


def _int8_library(xs, scales):
    """K2's library form, torch.fake_quantize_per_channel_affine one call a
    leaf (not bit-equal: x * (1/s) where K2 computes x / s), and a function
    that says how far its values are from K2's."""
    safe = [torch.where(s > 0, s, torch.ones_like(s)) for s in scales]
    zero_points = [torch.zeros(s.shape, dtype=torch.int32, device=s.device) for s in scales]
    operands = list(zip(xs, safe, zero_points))

    def distance():
        got = kernels.quantdequant_int8_grouped(xs, scales)
        lib = [_fake_quantize(*leaf) for leaf in operands]
        torch.cuda.synchronize()
        differ, steps = 0, 0.0
        for g, l, s in zip(got, lib, safe):
            d = (g - l).abs()
            differ += int((d > 0).sum())
            steps = max(steps, float((d / s[:, None]).max()))
        return {"library_elements_differing": differ, "library_elements": sum(x.numel() for x in xs),
                "library_max_diff_in_steps": steps}

    # fake_quantize checks its zero points on the host: it synchronizes.
    return {"library": _leaf_by_leaf(_fake_quantize, operands, own_syncs=True)}, distance


def int8_phase(peaks):
    """The grouped K2 (``_grouped_phase``): each round's leaves as one call
    (densenet_cifar's 362 in 5 launches, ShuffleNetV2's 170 and
    MobileNetV2's 173 in 2) and the edge lists; the small
    models' turns add the library call one leaf a call."""
    return _grouped_phase("quantdequant_int8", 4, peaks, round_forms=_int8_library)


def _hadamard_inputs(g, rows, h, dev):
    """Normal rows with a -0.0, zeros and large magnitudes mixed in (the
    sums then round at many places), and +-1 signs, drawn on the card from
    the generator ``g`` (a [64, 2^24] row is a billion draws)."""
    y = torch.randn((rows, h), generator=g, device=dev)
    y[0, 0] = -0.0
    y[0, 1 : 1 + h // 8] = 0.0
    y[-1, :: max(h // 16, 1)] = 1e30
    signs = torch.randint(0, 2, (h,), generator=g, device=dev).float() * 2 - 1
    return y, signs


def _hadamard_call(rows, h, peaks):
    """(bytes, bound in ms, what bounds it) of one K3 call: y read once,
    signs read once, out written once; log2(h) add/subtracts and two
    multiplies (signs, 1/sqrt(h)) per element."""
    call_bytes = 8 * rows * h + 4 * h
    call_ops = rows * h * (int(math.log2(h)) + 2)
    return (call_bytes, *_bound(call_bytes, call_ops, peaks))


def _hadamard_rates(ms, rows, h, peaks):
    """A K3 call's time beside its bound: the share of the bound, the rate
    the bound's bytes imply, and the bytes the memory rate moves in that
    time (twice the bound's bytes would mean the row crossed HBM twice)."""
    call_bytes, bound, _ = _hadamard_call(rows, h, peaks)
    return {
        "ms": ms, "call_bound_ms": bound, "share_of_bound": bound / ms,
        "implied_tb_per_s": call_bytes / ms / 1e9,
        "bytes_at_peak_rate_mb": ms * 1e-3 * peaks[0] / 1e6,
        "call_bytes_mb": call_bytes / 1e6,
    }


def _hadamard_round(fwd, inv, rows, h, peaks):
    """One rotq round's two K3 calls at ``[rows, h]``: times beside the
    bound."""
    call_bytes, call_bound, bound_by = _hadamard_call(rows, h, peaks)
    return {
        "shape": [rows, h], "ms": fwd[0] + inv[0], "plain_ms": fwd[1] + inv[1],
        "bound_ms": 2 * call_bound, "bound_by": bound_by, "bytes": 2 * call_bytes,
        "forward_ms": fwd[0], "inverse_ms": inv[0], "call_bound_ms": call_bound,
        "forward_share_of_bound": call_bound / fwd[0],
        "inverse_share_of_bound": call_bound / inv[0],
    }


def _floors(wrapper, y, signs):
    """Three yardsticks for a K3 call on y [rows, h], forward: a device
    copy of the same bytes (y read once, out written once: what the card's
    memory gives in practice); one pass of the kernel over the same bytes
    (the rows cut into 8192-wide ones, which need phase 0 only); and the
    two phases with every row's phase 0 before any phase 1, so that no
    intermediate is read back from L2 (what two plain launches would do)."""
    out = torch.empty_like(y)
    narrow = y.view(-1, 8192)
    narrow_signs = signs[:8192].contiguous()
    rows, h = y.shape
    no_reuse = kernels._hadamard_plan(h, rows)._replace(lag=rows)

    def two_launches_alike():
        kernels._hadamard_launch(y, signs, out, False, no_reuse)

    return {
        "copy_ms": _time_ms(lambda: out.copy_(y)),
        "one_pass_ms": _time_ms(lambda: wrapper(narrow, narrow_signs)),
        "no_reuse_ms": _time_ms(two_launches_alike),
    }


def hadamard_phase(peaks):
    """K3 forward and inverse bit-equal to the plain version at every
    shape; inverse(forward(y)) within 1e-5 of y (fedtpu's gate) on normal
    rows; timed beside its bound at the rotq row, where a round launches it
    twice, at MobileNet's row, at ResNet-18's, at ShuffleNetV2's and at
    EfficientNet-B0's."""
    dev = torch.device("cuda")
    wrapper, plain = kernels.KERNELS["hadamard_rotate"]
    g = torch.Generator(dev).manual_seed(3)
    max_err = 0.0
    timed = {}
    zoo_index = len(HADAMARD_SHAPES)
    zoo_shapes = {zoo_index: ZOO_HADAMARD_SHAPE, zoo_index + 1: ZOO2_HADAMARD_SHAPE,
                  zoo_index + 2: ZOO3_HADAMARD_SHAPE}
    for i, (rows, h) in enumerate([*HADAMARD_SHAPES, *zoo_shapes.values()]):
        y, signs = _hadamard_inputs(g, rows, h, dev)
        for inverse in (False, True):
            got = wrapper(y, signs, inverse=inverse)
            want = plain(y, signs, inverse)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got - want).abs().max()))
            if not _bits_equal(got, want):
                raise RuntimeError(
                    f"kernels: hadamard_rotate (inverse={inverse}) differs from its "
                    f"plain version at {rows}x{h}"
                )
            if i < 3 or i in zoo_shapes:
                timed[(i, inverse)] = (
                    _time_ms(lambda: wrapper(y, signs, inverse=inverse)),
                    _time_ms(lambda: plain(y, signs, inverse), runs=3, calls=1) if i != 2 else None,
                )
        if i == 0:
            floors = _floors(wrapper, y, signs)
        normal = torch.randn((rows, h), generator=g, device=dev)
        back = wrapper(wrapper(normal, signs), signs, inverse=True)
        err = float((back - normal).abs().max())
        if not torch.allclose(back, normal, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"kernels: hadamard_rotate round trip at {rows}x{h} off by {err}")
        log(f"kernels: hadamard_rotate {rows}x{h}: forward and inverse bit-equal; round trip max err {err:.3g}")
        del y, signs, normal, back, got, want
    for i, (rows, h) in [*enumerate(HADAMARD_SHAPES[:3]), *zoo_shapes.items()]:
        for inverse in (False, True):
            rates = _hadamard_rates(timed[(i, inverse)][0], rows, h, peaks)
            log(
                f"kernels: hadamard_rotate {rows}x{h} {'inverse' if inverse else 'forward'}: "
                + json.dumps(rates)
            )
    log(f"kernels: hadamard_rotate {HADAMARD_SHAPES[0]} yardsticks: " + json.dumps(floors))
    rows, h = HADAMARD_SHAPES[0]
    call_bytes, call_bound, bound_by = _hadamard_call(rows, h, peaks)
    fwd, inv = timed[(0, False)], timed[(0, True)]
    ms = fwd[0] + inv[0]
    result = {
        "name": "hadamard_rotate",
        "route": "cuda",
        "source": KERNEL_INFO["hadamard_rotate"]["source"],
        "replaces": KERNEL_INFO["hadamard_rotate"]["replaces"],
        "tpu_function": "hadamard_rotate",
        "bitwise_equal": True,
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": fwd[1] + inv[1],
        "bound_ms": 2 * call_bound,
        "bound_by": bound_by,
        "bytes": 2 * call_bytes,
        "library_ms": None,  # no PyTorch call computes an FWHT at these widths
        "per": f"one rotq round: a forward and an inverse call at [{rows}, {h}]",
        "forward_ms": fwd[0],
        "inverse_ms": inv[0],
        "forward_plain_ms": fwd[1],
        "inverse_plain_ms": inv[1],
        "call_bound_ms": call_bound,
        "forward_share_of_bound": call_bound / fwd[0],
        "inverse_share_of_bound": call_bound / inv[0],
        "mobilenet_rotq_round": _hadamard_round(timed[(1, False)], timed[(1, True)], *HADAMARD_SHAPES[1], peaks),
        "rows8_2p22_ms": {"forward": timed[(2, False)][0], "inverse": timed[(2, True)][0]},
        "resnet18_rotq_round": _hadamard_round(
            timed[(zoo_index, False)], timed[(zoo_index, True)], *ZOO_HADAMARD_SHAPE, peaks),
        "shufflenetv2_rotq_round": _hadamard_round(
            timed[(zoo_index + 1, False)], timed[(zoo_index + 1, True)], *ZOO2_HADAMARD_SHAPE, peaks),
        "efficientnetb0_rotq_round": _hadamard_round(
            timed[(zoo_index + 2, False)], timed[(zoo_index + 2, True)], *ZOO3_HADAMARD_SHAPE, peaks),
        **floors,
    }
    log(
        f"kernels: hadamard_rotate at {rows}x{h}: forward {fwd[0]:.4f} ms "
        f"(plain {fwd[1]:.4f}), inverse {inv[0]:.4f} ms "
        f"(plain {inv[1]:.4f}); bound per call {call_bound:.4f} ms "
        f"({call_bytes / 1e6:.1f} MB, {bound_by})"
    )
    return result


# ---------------------------------------------------------- 4. reference


def _small_cfg(compression_name, layout="per_leaf"):
    # No augmentation: the two devices would draw different crops.
    return RoundConfig(
        model="smallcnn",
        data=DataConfig(dataset="cifar10", batch_size=8, partition="iid", augment=False),
        fed=FedConfig(num_clients=4, compression=compression_name, delta_layout=layout),
        steps_per_round=2,
    )


def _injected(codec: compression.Compressor, draws) -> compression.Compressor:
    """``codec`` fed, each round, the draws ``draws(round_idx)`` makes on
    the CPU, moved to the row's device: both devices see the same ones."""

    def apply_flat(y, state, lay, round_idx=0):
        kw = {k: v.to(y.device) for k, v in draws(round_idx, lay).items()}
        return codec.apply_flat(y, state, lay, round_idx=round_idx, **kw)

    return codec._replace(apply_flat=apply_flat)


def _numpy_draws(codec_name, clients=4):
    """Seeded numpy draws per round: rotq's signs and uniforms, randk's
    coordinates; none for the unseeded codecs."""

    def draws(round_idx, lay):
        rng = np.random.default_rng(1000 + round_idx)
        if codec_name == "rotq":
            signs = (rng.integers(0, 2, size=lay.padded) * 2 - 1).astype(np.float32)
            unif = rng.random((clients, lay.padded), dtype=np.float32)
            return {"signs": torch.from_numpy(signs), "uniforms": torch.from_numpy(unif)}
        k = max(1, math.ceil(TOPK_FRACTION * lay.total))
        return {"indices": torch.from_numpy(rng.choice(lay.total, size=k, replace=False))}

    return draws


# (codec, layout, rounds). rotq is held for one round: a last-bit difference
# of a convolution can move one rotated coordinate across a stochastic-
# rounding step, which moves every coordinate of that client's row by
# scale / sqrt(h), and the next round's local training amplifies that.
REFERENCE_CASES = [
    ("none", "per_leaf", 2), ("topk", "per_leaf", 2), ("int8", "per_leaf", 2),
    ("topk", "flat", 2), ("int8", "flat", 2), ("rotq", "flat", 1), ("randk", "flat", 2),
]


def card_vs_cpu(label, cfg, data, comp, rounds=1, params_atol=1e-5, f64=False, step_mask=None, draws=None):
    """``rounds`` rounds of ``cfg`` on the card against the same rounds on
    the CPU (where the wrappers run their plain versions), from the same
    init and batches, the seeded codecs fed the same numpy draws; with
    ``f64`` the global model is f64 on both devices and the BatchNorm
    statistics are compared too. At most 0.1% of coordinates may lie
    beyond ``params_atol`` (1e-5 for the statistics) and rtol=1e-4: a
    last-bit difference in a delta can cross a top-k threshold or a
    rounding step. ``draws`` (a ``RoundDraws``) feeds both devices the
    same draws."""
    codec = compression.make_compressor(cfg.fed)
    if comp in ("rotq", "randk"):
        codec = _injected(codec, _numpy_draws(comp, clients=cfg.fed.num_clients))
    cpu = Federation(cfg, seed=0, data=data, device="cpu", compressor=codec, draws=draws)
    gpu = Federation(cfg, seed=0, data=data, compressor=codec, draws=draws)
    if f64:
        init = dict(params=cpu.state.params, batch_stats=cpu.state.batch_stats, dtype=torch.float64)
        cpu.state = init_state(cpu.model, cfg, codec, **init)
        gpu.state = init_state(gpu.model, cfg, codec, **init)
    else:
        gpu.state = gpu.state._replace(params={k: v.cuda() for k, v in cpu.state.params.items()})
    for r in range(rounds):
        cpu_b, gpu_b = cpu.device_batch(r, offset=r + 3), gpu.device_batch(r, offset=r + 3)
        if step_mask is not None:
            cpu_b, gpu_b = cpu_b._replace(step_mask=step_mask), gpu_b._replace(step_mask=step_mask.cuda())
        cpu.step(cpu_b)
        gpu.step(gpu_b)
    bad = total = 0
    worst = 0.0
    parts = (("params", params_atol), ("batch_stats", 1e-5)) if f64 else (("params", params_atol),)
    for part, atol in parts:
        for k, w in getattr(cpu.state, part).items():
            g = getattr(gpu.state, part)[k].cpu()
            if (f64 and g.dtype != torch.float64) or not torch.isfinite(g).all():
                raise RuntimeError(f"{label}: {k}: {g.dtype}, finite {bool(torch.isfinite(g).all())}")
            bad += int(((g - w).abs() > atol + 1e-4 * w.abs()).sum())
            total += w.numel()
            worst = max(worst, float((g - w).abs().max()))
    if bad > 0.001 * total:
        raise RuntimeError(f"{label}: {bad} of {total} coordinates differ from the CPU")
    log(
        f"{label}: card vs CPU after {rounds} {'f64 ' if f64 else ''}round(s), {bad} of {total} "
        f"coordinates beyond tolerance, largest difference {worst:.3g}"
    )


def reference_phase():
    """The port on the card against the port on the CPU (plain versions),
    smallcnn, 4 clients, f32, every codec and layout of REFERENCE_CASES."""
    rng = np.random.default_rng(1)
    images = rng.standard_normal((64, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    for comp, layout, rounds in REFERENCE_CASES:
        card_vs_cpu(f"reference: {layout} {comp}", _small_cfg(comp, layout), (images, labels), comp, rounds)


# (codec, layout) -> the params' atol: the MobileNet reference rounds. Both
# devices keep the global model in f64: at init, 27 BatchNorms over
# 4-example batches make MobileNet's gradient so ill-conditioned that two
# f32 summation orders (cuDNN's and the CPU's) part by far more than any
# tolerance within a round; in f64 the codecs (f32 on both) see nearly the
# same deltas. A last-bit difference of the f32 row can still move a
# rotated coordinate across a stochastic-rounding step, which moves every
# coordinate of that client's row by step / 2048 (about 6e-6 here): rotq's
# params are held to 2e-4, some thirty such steps.
# The codecs whose arithmetic does not depend on the model (top-k, int8)
# are held card against CPU at smallcnn's leaves (phase 4) and re-applied
# bit-equal at MobileNet's (phase 6); here MobileNet itself and its rotq
# row (2 steps each in f64; topk and int8 were cut for the script's time).
MOBILENET_REFERENCE_CASES = {("none", "per_leaf"): 1e-5, ("rotq", "flat"): 2e-4}


def mobilenet_reference_phase():
    """A small MobileNet round (2 clients, batch 4, 2 steps, one of them
    masked) on the card against the same round on the CPU, from the same
    init in f64: params and BatchNorm statistics within rtol=1e-4 and the
    case's atol (1e-5 for the statistics) on all but 0.1% of
    coordinates."""
    rng = np.random.default_rng(2)
    images = rng.standard_normal((16, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    for (comp, layout), params_atol in MOBILENET_REFERENCE_CASES.items():
        cfg = RoundConfig(
            model="mobilenet",
            data=DataConfig(dataset="cifar10", batch_size=4, partition="iid", augment=False),
            fed=FedConfig(num_clients=2, compression=comp, delta_layout=layout),
            steps_per_round=2,
        )
        card_vs_cpu(f"mobilenet reference: {layout} {comp}", cfg, (images, labels), comp,
                    params_atol=params_atol, f64=True, step_mask=torch.tensor([[True, True], [True, False]]))


# -------------------------------------------------------------- 5. slice


def bench_cfg(
    compression_name: str, layout: str = "per_leaf", model: str = "smallcnn",
    data_kw=None, fed_kw=None, clients: int = NUM_CLIENTS,
) -> RoundConfig:
    """bench.py's configuration (smallcnn) or the JAX package's flagship
    round (``tools/bench_model_tpu.py``: MobileNet, or any model it is
    given, the same data, steps and dtype, ``clients`` of them), with the
    update codec switched on."""
    return RoundConfig(
        model=model,
        num_classes=10,
        data=DataConfig(**{
            **dict(dataset="cifar10", batch_size=BATCH, partition="iid",
                   num_examples=NUM_CLIENTS * STEPS * BATCH),
            **(data_kw or {}),
        }),
        fed=FedConfig(
            num_clients=clients, compression=compression_name,
            topk_fraction=TOPK_FRACTION, delta_layout=layout, **(fed_kw or {}),
        ),
        steps_per_round=STEPS,
        dtype="bfloat16",
    )


def _moved(x, device):
    """A copy of a tensor, or of a dict of them, on ``device``; anything
    else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return {k: v.to(device, copy=True) for k, v in x.items()} if isinstance(x, dict) else x


class Recorder:
    """Wraps a codec; keeps the inputs and outputs of the round it is armed
    for, so the plain codec can be re-applied to the same tensors. The
    copies wait in host memory: a config-4 round's are some 11 GB, more
    than its peak leaves free on the card."""

    def __init__(self, codec: compression.Compressor):
        self.codec = codec
        self.armed = False
        self.seen = None

    def apply(self, deltas, state):
        out, new_state = self.codec.apply(deltas, state)
        if self.armed:
            self.seen = ((_moved(deltas, "cpu"), _moved(state, "cpu")), {},
                         _moved(out, "cpu"), _moved(new_state, "cpu"))
            self.armed = False
        return out, new_state

    def apply_flat(self, y, state, lay, round_idx=0):
        out, new_state = self.codec.apply_flat(y, state, lay, round_idx=round_idx)
        if self.armed:
            self.seen = ((_moved(y, "cpu"), _moved(state, "cpu"), lay), {"round_idx": round_idx},
                         _moved(out, "cpu"), _moved(new_state, "cpu"))
            self.armed = False
        return out, new_state

    def compressor(self) -> compression.Compressor:
        flat = self.codec.layout == "flat"
        return self.codec._replace(
            apply=self.apply, apply_flat=self.apply_flat if flat else None
        )


def _tensors(x):
    """Every tensor of a tensor, a (nested) dict of them, or ``()``."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x.values() for t in _tensors(v)] if isinstance(x, dict) else []


def _state_tensors(state):
    yield from state.params.values()
    yield from state.batch_stats.values()
    yield from state.opt_state.values()
    yield from _tensors(state.comp_state)


def _launch_counts():
    return {name: wrapper.launches for name, (wrapper, _) in kernels.KERNELS.items()}


def slice_codecs(leaves: int):
    """(codec, layout) -> (kernel launched, launches per round, the same
    codec on the plain kernels), for a model of ``leaves`` parameter
    leaves, each of which needs the kernel (more than one element a client:
    top-k keeps all of a 1-element leaf without it)."""
    return {
        ("topk", "per_leaf"): ("threshold_feedback", -(-leaves // kernels.THRESHOLD_GROUP_CAPACITY),
                               lambda: compression.make_topk(
                                   TOPK_FRACTION, threshold=kernels.threshold_feedback_grouped_plain)),
        ("int8", "per_leaf"): ("quantdequant_int8", -(-leaves // kernels.INT8_GROUP_CAPACITY),
                               lambda: compression.make_int8(
                                   quantdequant=kernels.quantdequant_int8_grouped_plain)),
        ("rotq", "flat"): ("hadamard_rotate", 2, lambda: compression.make_rotq(
            4, rotate=kernels.hadamard_rotate_plain)),
        ("topk", "flat"): ("threshold_feedback", 1, lambda: compression.make_topk(
            TOPK_FRACTION, layout="flat", threshold=kernels.threshold_feedback_grouped_plain)),
        ("int8", "flat"): (None, 0, lambda: compression.make_int8(layout="flat")),
        ("none", "per_leaf"): (None, 0, None),
    }


SMALLCNN_SLICE = [("topk", "per_leaf"), ("int8", "per_leaf"), ("rotq", "flat"), ("topk", "flat"), ("int8", "flat")]
MOBILENET_SLICE = [("none", "per_leaf"), ("topk", "per_leaf"), ("int8", "per_leaf"), ("topk", "flat"), ("rotq", "flat")]


def check_rounds(fed, tag, codec, layout, counted, per_round, rec=None, make_plain=None,
                 rounds=CHECK_ROUNDS, peak=False):
    """``rounds`` rounds of ``fed`` through Federation.step, each round's
    launches checked (``per_round`` of ``counted``, 0 of the others), its
    loss and state finite and on the card; with a ``Recorder``, round 1's
    codec re-applied with ``make_plain()`` must give the same bits. Returns
    each round's record."""
    records = []
    for r in range(rounds):
        before = _launch_counts()
        if rec:
            rec.armed = r == 1
        if peak:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = fed.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = _launch_counts()
        for name in after:
            want = per_round if name == counted else 0
            if after[name] - before[name] != want:
                raise RuntimeError(
                    f"slice {tag} round {r}: {name} launched "
                    f"{after[name] - before[name]} times, expected {want}"
                )
        loss = float(m.loss)
        if not math.isfinite(loss):
            raise RuntimeError(f"slice {tag} round {r}: loss {loss}")
        for t in _state_tensors(fed.state):
            if t.device.type != "cuda":
                raise RuntimeError(f"slice {tag}: a state tensor is on {t.device}")
            if not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"slice {tag} round {r}: a state tensor is not finite")
        if any(not bool(e.any()) for e in _tensors(fed.state.comp_state)):
            raise RuntimeError(f"slice {tag} round {r}: a residual is all zero")
        record = {"round": r, "loss": loss, "round_s": secs,
                  "launches": {k: after[k] - before[k] for k in after}}
        if peak:
            record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        records.append(record)
        log(
            f"slice {tag} round {r}: loss {loss:.6f} acc {float(m.accuracy):.4f} "
            f"update_norm {float(m.update_norm):.6f} launches {record['launches']}"
            + (f" peak {record['peak_gb']:.2f} GB" if peak else "")
            + f" {secs:.3f} s"
        )
        if rec and r == 1:
            _check_recorded(rec, make_plain, layout, tag)
    return records


def _check_recorded(rec, make_plain, layout, tag):
    """The codec call ``rec`` recorded, re-applied on the card with the
    plain kernels between two rounds: the same output and residuals, bit
    for bit."""
    args, kw, out, new_state = rec.seen
    rec.seen = None
    plain = make_plain()
    args = tuple(_moved(a, "cuda") for a in args)
    out_p, new_p = (plain.apply_flat if layout == "flat" else plain.apply)(*args, **kw)
    out_p, new_p = _moved(out_p, "cpu"), _moved(new_p, "cpu")
    if layout == "flat":
        out, out_p, new_state, new_p = {"": out}, {"": out_p}, {"": new_state}, {"": new_p}
    for k in out:
        if not (_bits_equal(out[k], out_p[k]) and _bits_equal(new_state[k], new_p[k])):
            raise RuntimeError(f"slice {tag}: kernel codec differs from plain at {k!r}")
    log(f"slice {tag}: round 1's codec output and residuals bit-equal to the plain codec")
    del args, kw, out, new_state, out_p, new_p
    gc.collect()


def slice_phase(data, model="smallcnn", cases=SMALLCNN_SLICE, leaves=8):
    """A main path: CHECK_ROUNDS rounds per codec and layout through
    Federation.step, the launch counts set to 0 just before and read just
    after. Returns the engines (for timing) and this path's counts."""
    feds = {}
    codecs = slice_codecs(leaves)
    kernels.reset_launch_counts()
    for codec, layout in cases:
        counted, per_round, make_plain = codecs[(codec, layout)]
        cfg = bench_cfg(codec, layout, model)
        rec = Recorder(compression.make_compressor(cfg.fed)) if make_plain else None
        fed = Federation(cfg, seed=0, data=data, compressor=rec.compressor() if rec else None)
        log(f"slice {model} {layout} {codec}: engine built")
        check_rounds(fed, f"{model} {layout} {codec}", codec, layout, counted, per_round,
                     rec, make_plain, peak=model != "smallcnn")
        feds[(codec, layout)] = fed
    return feds, _launch_counts()


def mobilenet_options_phase(data, card):
    """One flagship round each on the gather layout and with the adam
    server optimizer (no codec): state on the card and finite, the layout
    and the server state what the config asks for; a second round timed."""
    out = {}
    for label, cfg in (
        ("gather", bench_cfg("none", model="mobilenet", data_kw={"device_layout": "gather"})),
        ("adam", bench_cfg("none", model="mobilenet", fed_kw={"server_optimizer": "adam", "server_lr": 0.01})),
    ):
        fed = Federation(cfg, seed=0, data=data)
        fed.run_on_device(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fed.run_on_device(1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        state = list(_state_tensors(fed.state)) + list(_tensors(fed.state.server_opt_state))
        if not torch.isfinite(m.loss).all() or any(
            t.device.type != "cuda" or not bool(torch.isfinite(t).all()) for t in state
        ):
            raise RuntimeError(f"mobilenet {label}: non-finite or off-card state")
        if label == "gather" and fed.layout != "gather":
            raise RuntimeError(f"mobilenet gather: the engine took the {fed.layout} layout")
        if label == "adam" and int(fed.state.server_opt_state["count"]) != 2:
            raise RuntimeError("mobilenet adam: the server optimizer did not step twice")
        out[label] = {"round_s": secs, "loss": float(m.loss[-1]), "card": card}
        log(f"mobilenet {label}: " + json.dumps(out[label]))
        del fed
    return out


def model_flops(model_name="mobilenet", classes=10, examples=NUM_CLIENTS * STEPS * BATCH):
    """Model FLOPs of a round of ``examples`` local examples: 3x the
    forward's (the backward twice the forward), the forward counted by
    torch.utils.flop_counter on meta tensors, per 32x32 example."""
    from torch.utils.flop_counter import FlopCounterMode

    model = models.create(model_name, classes).to("meta")
    with FlopCounterMode(display=False) as counter:
        model(torch.empty((1, 32, 32, 3), device="meta"))
    return 3 * counter.get_total_flops() * examples


TIMED_CASES = (
    ("none", "per_leaf"), ("topk", "per_leaf"), ("int8", "per_leaf"),
    ("none", "flat"), ("topk", "flat"), ("int8", "flat"), ("rotq", "flat"),
)


def timing_phase(feds, card, cases=TIMED_CASES, rounds=TIMED_ROUNDS, label="smallcnn"):
    """Rounds/s of each case after the checked rounds, through
    Federation.run_on_device, host clock around a synchronize:
    TIMING_REPEATS turns over every case (the order reversed on odd turns),
    the median reported with every turn, and each case's peak device
    memory."""
    secs = {case: [] for case in cases}
    peak = {}
    for turn in range(TIMING_REPEATS):
        for case in cases[:: -1 if turn % 2 else 1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = feds[case].run_on_device(rounds)
            torch.cuda.synchronize()
            secs[case].append(time.perf_counter() - t0)
            peak[case] = torch.cuda.max_memory_allocated() / 1e9
            if not torch.isfinite(m.loss).all():
                raise RuntimeError(f"timing {label} {case}: non-finite loss {m.loss.tolist()}")
    rates = {}
    for (codec, layout), dts in secs.items():
        per_s = [rounds / dt for dt in dts]
        rates[(codec, layout)] = {
            "model": label,
            "compression": codec,
            "delta_layout": layout,
            "rounds": rounds,
            "repeats": TIMING_REPEATS,
            "rounds_per_s": statistics.median(per_s),
            "rounds_per_s_each": per_s,
            "client_epochs_per_s": statistics.median(per_s) * NUM_CLIENTS,
            "client_epochs_per_s_each": [r * NUM_CLIENTS for r in per_s],
            "peak_mem_gb": peak[(codec, layout)],
            "card": card,
        }
        log("timing: " + json.dumps(rates[(codec, layout)]))
    return rates


def pack_phase(fed, peaks, card):
    """The flat pack of one round's deltas (64 clients, permuted to flax's
    layout) and the unpack of the mean row, timed as the kernels are."""
    params = fed.state.params
    g = torch.Generator(device="cuda").manual_seed(5)
    deltas = {
        k: torch.randn((NUM_CLIENTS,) + tuple(v.shape), generator=g, device="cuda")
        for k, v in params.items()
    }
    lay = flat.make_layout(params)
    row = flat.pack_stacked(lay, deltas)
    back = flat.unpack_stacked(lay, row)
    if any(not torch.equal(back[k], v) for k, v in deltas.items()):
        raise RuntimeError("pack: unpack_stacked(pack_stacked(d)) is not d")
    pack_ms = _time_ms(lambda: flat.pack_stacked(lay, deltas))
    unpack_ms = _time_ms(lambda: flat.unpack(lay, row[0]))
    # Each delta read once, the padded buffer written once.
    pack_bytes = 4 * NUM_CLIENTS * (lay.total + lay.padded)
    bound, _ = _bound(pack_bytes, 0, peaks)
    result = {
        "pack_ms": pack_ms, "pack_bound_ms": bound, "pack_bytes": pack_bytes,
        "unpack_mean_ms": unpack_ms, "card": card,
    }
    log("pack: " + json.dumps(result))
    return result


# Kernel groups of the round, by name: first match wins.
KERNEL_GROUPS = (
    ("max-pool backward", "max_pool_backward"),
    ("max-pool forward", "max_pool_forward"),
    ("layout conversion", "nchwToNhwc|nhwcToNchw"),
    ("depthwise or grouped convolution", "(?i)depthwise|grouped|dgrad2d_grouped|conv2d_c1_k1"),
    ("convolution", "convolve|xmma|cutlass|wgrad|dgrad|gemm|implicit_convolve|sm90"),
    ("reductions (BatchNorm statistics, means)", "reduce_kernel"),
    ("copy", "copy|Memcpy"),
    ("K1 threshold_feedback", "threshold_feedback"),
    ("K2 quantdequant_int8", "quantdequant_int8"),
    ("K3 hadamard_rotate", "hadamard_rotate_kernel"),
    ("torch.topk", "topk|RadixSort|radixSort"),
    ("other elementwise and reductions", ""),
)


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _on_device(e) -> bool:
    """A profiler event of the card's own: a kernel, a copy or a memset
    (by its activity where the event carries one, else by its device)."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_ACTIVITIES
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _span_us(e):
    """(start, duration) of a profiler event, in us."""
    if hasattr(e, "start_ns"):
        return e.start_ns() / 1e3, e.duration_ns() / 1e3
    return float(e.start_us()), float(e.duration_us())


def _device_summary(prof, rounds: int):
    """From a stopped profiler's events, read as they are (no trace file):
    device ms per round by kernel name, the union of the device's busy
    intervals and the window's span, in ms."""
    device = [(e.name(), *_span_us(e)) for e in prof.profiler.kineto_results.events() if _on_device(e)]
    if not device:
        raise RuntimeError("profile: the trace holds no device activity")
    by_name = collections.Counter()
    for name, _, dur in device:
        by_name[name] += dur / 1e3 / rounds
    intervals = sorted((start, start + dur) for _, start, dur in device)
    busy, run = 0.0, list(intervals[0])
    for start, stop in intervals[1:]:
        if start <= run[1]:
            run[1] = max(run[1], stop)
        else:
            busy += run[1] - run[0]
            run = [start, stop]
    busy += run[1] - run[0]
    span = max(stop for _, stop in intervals) - intervals[0][0]
    return by_name, busy / 1e3, span / 1e3


def profile_phase(fed, out_dir: Optional[Path], label: str, rounds: int = 2, warm: bool = True):
    """torch.profiler over ``rounds`` rounds (after one more round unless
    the engine is ``warm`` already): device time by kernel, by group, and
    the device's idle share of the window, and with an ``out_dir`` the
    profiler's table of ops there. Without one only the device is traced:
    the host's op events are what make a trace slow to write and read, and
    recording them slows the host the idle share is read against. Returns
    ms per round by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fed.run_on_device(1)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if out_dir is not None else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fed.run_on_device(rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stop_s = time.perf_counter() - t0 - wall_ms / 1e3
    if out_dir is not None:
        # The table's event tree takes minutes to build for a round of
        # ShuffleNetV2's tens of thousands of ops: only when it is kept.
        out_dir.mkdir(parents=True, exist_ok=True)
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
        (out_dir / f"profile_{label}.txt").write_text(table)
    t_read = time.perf_counter()
    by_name, busy_ms, span_ms = _device_summary(prof, rounds)
    read_s = time.perf_counter() - t_read
    groups = collections.Counter()
    for name, ms in by_name.items():
        group = next(g for g, pattern in KERNEL_GROUPS if re.search(pattern, name))
        groups[group] += ms
    log(
        f"profile {label}: {rounds} rounds, {wall_ms:.1f} ms wall under the profiler; "
        f"kernels sum {sum(by_name.values()) * rounds:.1f} ms, the device busy "
        f"{busy_ms:.1f} ms of the {span_ms:.1f} ms from its first kernel to its last "
        f"(idle {100 * (1 - busy_ms / span_ms):.1f}%); the profiler stopped in {stop_s:.1f} s and "
        f"its events were read in {read_s:.1f} s"
    )
    log(f"profile {label}: ms per round by group " + json.dumps({g: round(v, 3) for g, v in groups.most_common()}))
    for name, ms in by_name.most_common(12):
        log(f"profile {label}: {ms:8.3f} ms/round  {name[:100]}")
    return by_name, 1 - busy_ms / span_ms


def profile_diff(base, other, label: str, base_label: str):
    """The kernels whose time per round differs most between two profiles."""
    diff = {k: other.get(k, 0.0) - base.get(k, 0.0) for k in set(base) | set(other)}
    log(f"profile {label} - {base_label}: {sum(diff.values()):+.3f} ms per round of kernel time")
    for name, ms in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:10]:
        log(f"profile {label} - {base_label}: {ms:+8.3f} ms/round  {name[:100]}")


# --------------------------------------------------- 7. options reference


# name -> (DataConfig, FedConfig, OptimizerConfig fields) of a small round.
OPTIONS_REFERENCE_CASES = {
    "median": ({}, dict(aggregator="median", weighted=False), {}),
    "trimmed_mean": ({}, dict(aggregator="trimmed_mean", trim_fraction=0.1, weighted=False), {}),
    "krum": ({}, dict(aggregator="krum", trim_fraction=0.25, weighted=False), {}),
    "dp": ({}, dict(dp_clip_norm=1.0, dp_noise_multiplier=1.0, weighted=False), {}),
    "screen": ({}, dict(weighted=False, screen=ScreenConfig(zmax=6.0, cos_min=-0.5),
                        sim=SimConfig(malicious_fraction=0.25, attack="scale:factor=-8")), {}),
    "fedprox_dirichlet": (dict(partition="dirichlet", dirichlet_alpha=0.5),
                          dict(algorithm="fedprox", fedprox_mu=0.01), {}),
    "megabatch": ({}, dict(megabatch_clients=2), {}),
    "bf16_momentum": ({}, {}, dict(momentum_dtype="bfloat16")),
}


def _cpu_normals(round_idx, tree):
    """DP noise drawn on the CPU, the same on both devices."""
    g = torch.Generator().manual_seed(1000 + round_idx)
    return {k: torch.randn(tree[k].shape, generator=g) for k in sorted(tree)}


def _same_batch(fed, r):
    """Round ``r``'s batch with the same draws on either device: the
    presharded rotation offset, or the gather layout's sort keys."""
    if fed.layout == "gather":
        keys = torch.rand(fed.client_idx.shape, generator=torch.Generator().manual_seed(100 + r))
        return fed.device_batch(r, keys=keys)
    return fed.device_batch(r, offset=r + 3)


class KrumSpy:
    """Records the client Krum chooses in each round while armed: the row
    of the deltas that equals its output."""

    def __init__(self):
        self.chosen = []
        self.inner = round_lib._krum_over_clients

    def __call__(self, trees, alive_w, trim):
        out = self.inner(trees, alive_w, trim)
        rows = torch.cat([x.reshape(x.shape[0], -1).float() for t in trees for x in round_lib._items(t).values()], 1)
        pick = torch.cat([x.reshape(-1).float() for t in out for x in round_lib._items(t).values()])
        hits = torch.nonzero((rows == pick[None]).all(1)).flatten().tolist()
        if len(hits) != 1:
            raise RuntimeError(f"options reference: Krum's output matches rows {hits}")
        self.chosen.append(hits[0])
        return out

    def __enter__(self):
        round_lib._krum_over_clients = self
        return self

    def __exit__(self, *exc):
        round_lib._krum_over_clients = self.inner


def options_reference_phase():
    """Each round option in one small round (4 smallcnn clients, f32) on the
    card and on the CPU from the same init: params within atol=1e-5,
    rtol=1e-4 on all but 0.1% of coordinates (the reference phase's
    tolerance), the screened rows and Krum's chosen client equal, finite
    state."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((64, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    for name, (data_kw, fed_kw, opt_kw) in OPTIONS_REFERENCE_CASES.items():
        cfg = RoundConfig(
            model="smallcnn",
            data=DataConfig(**{**dict(dataset="cifar10", batch_size=8, partition="iid", augment=False), **data_kw}),
            fed=FedConfig(num_clients=4, **fed_kw),
            opt=OptimizerConfig(**opt_kw),
            steps_per_round=2,
        )
        draws = RoundDraws(dp_noise=_cpu_normals) if name == "dp" else None
        cpu = Federation(cfg, seed=0, data=(images, labels), device="cpu", draws=draws)
        gpu = Federation(cfg, seed=0, data=(images, labels), draws=draws)
        gpu.state = gpu.state._replace(params={k: v.cuda() for k, v in cpu.state.params.items()})
        runs = {}
        for dev, fed in (("cpu", cpu), ("cuda", gpu)):
            with KrumSpy() as spy:
                m = fed.step(_same_batch(fed, 0))
            runs[dev] = (fed, m, spy.chosen)
        (cpu, m_cpu, k_cpu), (gpu, m_gpu, k_gpu) = runs["cpu"], runs["cuda"]
        bad = total = 0
        for k, w in cpu.state.params.items():
            g = gpu.state.params[k].cpu()
            if not torch.isfinite(g).all():
                raise RuntimeError(f"options reference: {name}: non-finite {k}")
            bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
            total += w.numel()
        if bad > 0.001 * total:
            raise RuntimeError(f"options reference: {name}: {bad} of {total} coordinates differ from the CPU")
        if k_cpu != k_gpu:
            raise RuntimeError(f"options reference: {name}: Krum chose {k_gpu} on the card, {k_cpu} on the CPU")
        if not torch.equal(m_gpu.screened.cpu(), m_cpu.screened):
            raise RuntimeError(
                f"options reference: {name}: screened {m_gpu.screened.tolist()} on the card, "
                f"{m_cpu.screened.tolist()} on the CPU"
            )
        if name == "screen" and not bool(m_cpu.screened[torch.from_numpy(cpu.attacker_clients)].all()):
            raise RuntimeError("options reference: screen: the attacker was not screened")
        log(
            f"options reference: {name}: card vs CPU after one round, {bad} of {total} coordinates "
            f"beyond tolerance; screened {m_gpu.screened.tolist()}; Krum chose {k_gpu}; layout {gpu.layout}"
        )


# ---------------------------------------------------------------- 8. options


# (label, model, codec, layout, DataConfig / FedConfig / OptimizerConfig /
# RoundConfig fields, K launches a round by kernel). Dirichlet(0.5) over
# 64 clients skews the shards, so (a)-(c) take the gather layout.
_SKEWED = dict(partition="dirichlet", dirichlet_alpha=0.5)
_PROX = dict(algorithm="fedprox", fedprox_mu=0.01)
OPTIONS_CASES = (
    ("mean", "mobilenet", "none", "per_leaf", {}, dict(weighted=False), {}, {}, {}),
    ("a: dirichlet fedprox loss-sampled int8", "mobilenet", "int8", "per_leaf", _SKEWED,
     dict(_PROX, participation_fraction=0.5, participation_sampling="loss"), {}, {}, {"quantdequant_int8": 1}),
    ("b: dirichlet fedprox flat topk screened attacked", "mobilenet", "topk", "flat", _SKEWED,
     dict(_PROX, weighted=False, screen=ScreenConfig(zmax=6.0, cos_min=-0.5),
          sim=SimConfig(malicious_fraction=0.125, attack="scale:factor=-8")), {}, {}, {"threshold_feedback": 1}),
    ("c: dirichlet fedprox flat rotq", "mobilenet", "rotq", "flat", _SKEWED, _PROX, {}, {}, {"hadamard_rotate": 2}),
    ("d: median", "mobilenet", "none", "per_leaf", {}, dict(aggregator="median", weighted=False), {}, {}, {}),
    ("d: trimmed_mean 0.1", "mobilenet", "none", "per_leaf", {},
     dict(aggregator="trimmed_mean", trim_fraction=0.1, weighted=False), {}, {}, {}),
    ("d: krum 0.1", "mobilenet", "none", "per_leaf", {}, dict(aggregator="krum", trim_fraction=0.1, weighted=False),
     {}, {}, {}),
    ("e: megabatch 4", "mobilenet", "none", "per_leaf", {}, dict(weighted=False, megabatch_clients=4), {}, {}, {}),
    ("e: bf16 momentum", "mobilenet", "none", "per_leaf", {}, dict(weighted=False),
     dict(momentum_dtype="bfloat16"), {}, {}),
    ("e: remat", "mobilenet", "none", "per_leaf", {}, dict(weighted=False), {}, dict(remat=True), {}),
    ("smallcnn mean", "smallcnn", "none", "per_leaf", {}, dict(weighted=False), {}, {}, {}),
    ("d: smallcnn dp", "smallcnn", "none", "per_leaf", {},
     dict(weighted=False, dp_clip_norm=1.0, dp_noise_multiplier=1.0), {}, {}, {}),
)
OPTIONS_ROUNDS = 2  # a turn's rounds per engine; the last one is timed


def options_cfg(model, codec, layout, data_kw, fed_kw, opt_kw, round_kw) -> RoundConfig:
    cfg = bench_cfg(codec, layout, model, data_kw=data_kw, fed_kw=fed_kw)
    return dataclasses.replace(cfg, opt=OptimizerConfig(**opt_kw), **round_kw)


def _finite_state(fed) -> bool:
    state = list(_state_tensors(fed.state)) + list(_tensors(fed.state.server_opt_state))
    return all(t.device.type == "cuda" and bool(torch.isfinite(t).all()) for t in state)


def remat_probe(data, card):
    """Where remat's memory goes, in one local step of the full-width
    MobileNet round (64 clients x 128 examples, bf16) taken through
    torch.func.vjp of the vmapped loss, with and without remat: the device
    memory the forward leaves held for the backward, and the step's peak
    (both above the memory held before the step)."""
    from torch.func import functional_call, vjp, vmap

    from fedtpu_torch.ops.losses import softmax_ce_int_labels

    out = {}
    for remat in (False, True):
        fed = Federation(options_cfg("mobilenet", "none", "per_leaf", {}, {}, {}, dict(remat=remat)), seed=0, data=data)
        batch = fed.device_batch(0)
        x, y = batch.x[:, 0].to(torch.bfloat16), batch.y[:, 0]
        n = x.shape[0]
        params = {k: v.expand((n,) + tuple(v.shape)) for k, v in fed.state.params.items()}
        stats = {k: v.expand((n,) + tuple(v.shape)) for k, v in fed.state.batch_stats.items()}

        def loss(p, s, x, y, model=fed.model):
            cast = {k: v.to(torch.bfloat16) for k, v in p.items()}
            logits, _ = functional_call(model, (cast, s), (x,), {"train": True})
            return softmax_ce_int_labels(logits.float(), y).mean()

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, back = vjp(lambda p: vmap(loss)(p, stats, x, y), params)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        grads = back(torch.ones_like(losses))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not all(bool(torch.isfinite(g).all()) for g in grads[0].values()):
            raise RuntimeError(f"remat probe: non-finite gradients (remat={remat})")
        out["remat" if remat else "plain"] = {"held_after_forward_gb": held / 1e9, "step_peak_gb": peak / 1e9}
        del fed, batch, x, y, params, stats, losses, back, grads
        gc.collect()
        torch.cuda.empty_cache()
    log("options: remat probe, one local step: " + json.dumps({**out, "card": card}))
    return out


def options_phase(data, card):
    """This slice's main path: every case of OPTIONS_CASES through
    Federation.run, TIMING_REPEATS turns over the cases (the order reversed
    on odd turns), each engine built, driven OPTIONS_ROUNDS rounds
    and freed before the next. The counts are set to 0 before the phase
    and read after it; each round's launches are checked against the
    case's. Returns the per-case results and the phase's counts."""
    secs = {c[0]: [] for c in OPTIONS_CASES}
    peak, rounds_log = {}, {c[0]: [] for c in OPTIONS_CASES}
    kernels.reset_launch_counts()
    for turn in range(TIMING_REPEATS):
        for label, model, codec, layout, data_kw, fed_kw, opt_kw, round_kw, want in OPTIONS_CASES[:: -1 if turn % 2 else 1]:
            fed = Federation(options_cfg(model, codec, layout, data_kw, fed_kw, opt_kw, round_kw), seed=0, data=data)
            if data_kw and fed.layout != "gather":
                raise RuntimeError(f"options {label}: Dirichlet shards took the {fed.layout} layout")
            for r in range(OPTIONS_ROUNDS):
                before = _launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                m = fed.run(1)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                after = _launch_counts()
                launched = {k: after[k] - before[k] for k in after}
                if any(launched[k] != want.get(k, 0) for k in launched):
                    raise RuntimeError(f"options {label} turn {turn} round {r}: launches {launched}, expected {want}")
                rec = fed.history[-1]
                if "screened" in rec:
                    caught = m.screened.cpu()[torch.from_numpy(fed.attacker_clients)]
                    rec["attackers_screened"] = int(caught.sum())
                    if not bool(caught.all()):
                        raise RuntimeError(f"options {label} turn {turn} round {r}: an attacker was not screened")
                if not math.isfinite(rec["loss"]) or not _finite_state(fed):
                    raise RuntimeError(f"options {label} turn {turn} round {r}: non-finite loss or state")
                rounds_log[label].append({
                    k: rec[k] for k in ("round", "loss", "active", "screened", "attackers_fired", "attackers_screened")
                    if k in rec
                })
            secs[label].append(dt)
            peak[label] = torch.cuda.max_memory_allocated() / 1e9
            del fed
            gc.collect()
    results = {}
    for label, dts in secs.items():
        per_s = [1.0 / dt for dt in dts]
        results[label] = {
            "rounds_per_s": statistics.median(per_s),
            "rounds_per_s_each": per_s,
            "peak_mem_gb": peak[label],
            "launches_per_round": next(c[-1] for c in OPTIONS_CASES if c[0] == label),
            "rounds": rounds_log[label],
            "card": card,
        }
        log(f"options {label}: " + json.dumps(results[label]))
    for label, base in (("e: remat", "mean"),):
        log(f"options: remat peak {peak[label]:.2f} GB against {peak[base]:.2f} GB without remat")
    return results, _launch_counts()


# ------------------------------------------------------------------ 9. edge

EDGE_TRAINERS = 4  # ranks 0..3 of a world of NUM_CLIENTS
# Local steps of a client round on the edge, federation and faults paths:
# the flagship's 6 cut to 2. These paths are the host's (a client's update,
# the codecs, gRPC, the coordinator); each client's shard is 2 batches.
HOST_STEPS = 2
# The edge's row is fedtpu's ``{"params", "batch_stats"}`` tree: MobileNet's
# 3,217,226 params in 83 leaves and 21,888 BatchNorm statistics in 54.
EDGE_P, EDGE_LEAVES = 3_239_114, 137
EDGE_ROUNDS = 1  # rounds per codec, after the dense round 0
# (layout, configured codec, the codecs run in turn through codec_override)
EDGE_GROUPS = (
    ("per_leaf", "topk", ("none", "topk", "int8")),
    ("flat", "rotq", ("topk", "int8", "rotq", "randk")),
)
# The server functions: name -> FedConfig fields of aggregate's config
# (None: finalize_stream).
EDGE_SERVER = {
    "finalize_stream": None,
    "aggregate_mean": dict(aggregator="mean"),
    "aggregate_median": dict(aggregator="median"),
    "aggregate_trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.1),
    "aggregate_krum": dict(aggregator="krum", trim_fraction=0.1),
}


def _edge_small_cfg(codec: str, layout: str) -> RoundConfig:
    # No augmentation: the two devices would draw different crops. A
    # learning rate of 0.01 keeps rotq's step (scale / sqrt(h) per moved
    # code) under the tolerance, as in tests/test_torch_edge.py.
    return RoundConfig(
        model="smallcnn",
        opt=OptimizerConfig(learning_rate=0.01),
        data=DataConfig(dataset="cifar10", batch_size=8, partition="iid", augment=False, num_examples=64),
        fed=FedConfig(num_clients=2, compression=codec, delta_layout=layout, topk_fraction=0.1),
    )


def _beyond(got: np.ndarray, want: np.ndarray) -> int:
    return int((np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)).sum())


def _reply_row(t, data: bytes, base: dict) -> np.ndarray:
    """A reply decoded on the host: the FSP1 delta, or the FTP1 weights
    minus ``base``, as one f32 row in the edge's order."""
    row = np.zeros(t.layout.total, np.float32)
    if sparse.is_sparse_payload(data):
        sparse.decode_into_row(data, t.layout.sizes, row)
    else:
        wire.decode_into_row(data, dict(base, num_examples=np.zeros((), np.float32)), base, row)
    return row


def edge_reference_phase():
    """A small LocalTrainer (smallcnn, f32, 4 steps of batch 8) on the card
    against the same trainer on the CPU, from one synced global model, per
    codec and layout of REFERENCE_CASES with fresh trainers (a difference
    of one case would otherwise carry into the next through the residual:
    a top-k threshold crossed by the largest coordinate of a leaf moves
    the int8 scale of the whole leaf): every reply decoded and held, as
    the reference phase holds rounds, to at most 0.1% of coordinates
    beyond atol=1e-5, rtol=1e-4."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((64, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    data = (images, labels)
    for codec, layout, rounds in REFERENCE_CASES:
        cfg = _edge_small_cfg(codec, layout)
        cpu = LocalTrainer(cfg, seed=0, device="cpu", data=data, eval_data=data)
        gpu = LocalTrainer(cfg, seed=0, data=data, eval_data=data)
        g = wire.encode(cpu.host_model())
        cpu.set_global(g)
        gpu.set_global(g)
        for r in range(rounds):
            base = cpu.host_model()
            got = _reply_row(gpu, gpu.train_round(1, 2), base)
            want = _reply_row(cpu, cpu.train_round(1, 2), base)
            if not np.isfinite(got).all():
                raise RuntimeError(f"edge reference: non-finite {layout} {codec} reply")
            bad = _beyond(got, want)
            if bad > 0.001 * want.size:
                raise RuntimeError(
                    f"edge reference: {layout} {codec} round {r}: {bad} of {want.size} "
                    "coordinates differ from the CPU"
                )
            log(f"edge reference: {layout} {codec} round {r}: card vs CPU reply, "
                f"{bad} of {want.size} coordinates beyond tolerance")


def _leaves_row(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in wire.tree_leaves(tree)])


def _check_reply(label: str, t, data: bytes, decoded: np.ndarray, x: np.ndarray, residual) -> None:
    """A synced lossy reply against its delta ``x`` (the round's delta plus
    the residual carried in): the residual left is exactly ``x - decoded``,
    and the codec's own error bound holds (top-k keeps the largest
    magnitudes, int8 is within half a step of each leaf's scale and two
    roundings, rotq's
    error is under one step per rotated coordinate in L2, random-k keeps
    at most k coordinates)."""
    res = _leaves_row(residual) if residual is not None else np.zeros_like(x)
    if not np.array_equal(x - decoded, res):
        raise RuntimeError(f"edge {label}: residual is not the delta minus the decoded reply")
    body = _msgpack.msgpack_restore(data[10:])
    kind, err = body["kind"], np.abs(x - decoded)
    if kind in ("topk", "topk_flat"):
        spans = list(zip(t.layout.offsets, t.layout.sizes)) if kind == "topk" else [(0, x.size)]
        for off, n in spans:
            kept = decoded[off : off + n] != 0
            if kept.any() and np.abs(res[off : off + n]).max(initial=0.0) > np.abs(decoded[off : off + n][kept]).min():
                raise RuntimeError(f"edge {label}: a dropped coordinate outweighs a kept one")
    elif kind in ("int8", "int8_flat"):
        scales = ([float(body["leaves"][str(i)]["scale"]) for i in range(len(body["leaves"]))]
                  if kind == "int8" else np.asarray(body["scales"]).tolist())
        for (off, n), s in zip(zip(t.layout.offsets, t.layout.sizes), scales):
            # Half a step, and the two roundings (of x * f32(1 / s) and of
            # s * code), each under an ulp of the leaf's largest value.
            if err[off : off + n].max(initial=0.0) > 0.5 * s + 2 * float(np.spacing(np.float32(127 * s))):
                raise RuntimeError(f"edge {label}: int8 error beyond half a step")
    elif kind == "rotq_flat":
        h = flat.next_pow2(x.size)
        if float(np.sqrt(np.sum(err.astype(np.float64) ** 2))) > float(body["extra"]["scale"]) * math.sqrt(h):
            raise RuntimeError(f"edge {label}: rotq error beyond one step a rotated coordinate")
    elif kind == "randk_flat":
        if int((decoded != 0).sum()) > int(body["extra"]["k"]):
            raise RuntimeError(f"edge {label}: random-k kept more than k coordinates")


def _edge_server_calls(layout, gtree, rows, weights):
    """name -> a call of each server function on ``rows``."""
    stacked = {"params": {}, "batch_stats": {}}
    for name, leaf in flat.unpack_stacked(layout, rows).items():
        col, rest = name.split(".", 1)
        stacked[col][rest] = leaf
    calls = {}
    for name, fed_kw in EDGE_SERVER.items():
        if fed_kw is None:
            cfg = bench_cfg("none", "flat", "mobilenet")
            calls[name] = lambda cfg=cfg: edge_aggregation.finalize_stream(cfg, layout, gtree, rows, weights, ())
        else:
            cfg = bench_cfg("none", "per_leaf", "mobilenet", fed_kw=fed_kw)
            calls[name] = lambda cfg=cfg: edge_aggregation.aggregate(cfg, gtree, stacked, weights, (), 1)
    return calls


def _krum_choice(rows: torch.Tensor, trim: float) -> int:
    """The row Krum picks from ``rows`` (all live), by the port's
    selection (an f64 Gram matrix; the chosen row copied exactly)."""
    alive = torch.ones((rows.shape[0],), device=rows.device)
    (chosen,) = round_lib._krum_over_clients((rows,), alive, trim)
    same = [i for i in range(rows.shape[0]) if torch.equal(rows[i], chosen)]
    return same[0] if same else -1


def edge_phase(data, card):
    """The port's client at MobileNet's full width: EDGE_TRAINERS
    LocalTrainers (ranks 0-3 of 64, 256 examples each, HOST_STEPS steps of
    batch 128 in bf16) on one shared copy of the data, for each group of
    EDGE_GROUPS a dense round 0 (unsynced) and, from one synced global
    model, EDGE_ROUNDS rounds of each codec; every reply decoded into a
    [64, P] f32 row buffer on the card (rows 4-63 copies of rows 0-3) and
    checked against its delta; the server functions run on the buffer and
    held against the CPU on its 4 distinct rows. No kernel of K1-K3 lies
    on this path: the counts are set to 0 before and must read 0 after."""
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stats = collections.defaultdict(lambda: collections.defaultdict(list))
    n = NUM_CLIENTS * HOST_STEPS * BATCH
    data, eval_data = (data[0][:n], data[1][:n]), (data[0][:256], data[1][:256])
    for layout_name, codec, chain in EDGE_GROUPS:
        cfg = bench_cfg(codec, layout_name, "mobilenet", data_kw=dict(num_examples=n))
        trainers = [LocalTrainer(cfg, seed=k, data=data, eval_data=eval_data) for k in range(EDGE_TRAINERS)]
        lay = trainers[0].layout
        if (lay.total, lay.num_leaves) != (EDGE_P, EDGE_LEAVES):
            raise RuntimeError(f"edge: MobileNet's edge row is {lay.total} in {lay.num_leaves} leaves")
        buf = torch.zeros((NUM_CLIENTS, lay.padded), dtype=torch.float32, device="cuda")
        global_model = trainers[0].host_model()
        g_bytes = wire.encode(global_model)
        gtree = flat.unpack_tree(lay, torch.from_numpy(np.pad(_leaves_row(global_model), (0, lay.pad))).cuda())
        like = dict(global_model, num_examples=np.zeros((), np.float32))
        for override in ["dense"] + [c for c in chain for _ in range(EDGE_ROUNDS)]:
            for k, t in enumerate(trainers):
                start = t.host_model()
                before = _leaves_row(t.edge_residual) if t.edge_residual is not None else None
                reply = t.train_round(k, NUM_CLIENTS, codec_override=None if override == "dense" else override)
                label = f"{layout_name} {override} rank {k}"
                t0 = time.perf_counter()
                if sparse.is_sparse_payload(reply):
                    extra = sparse.decode_into_row(reply, lay.sizes, buf[k])
                else:
                    base = global_model if override == "dense" else start
                    extra = wire.decode_into_row(reply, like, base, buf[k])
                decode_s = time.perf_counter() - t0
                if float(extra["num_examples"]) != HOST_STEPS * BATCH:
                    raise RuntimeError(f"edge {label}: num_examples {extra['num_examples']}")
                decoded = buf[k, : lay.total].cpu().numpy()
                delta = _leaves_row(t.host_model()) - _leaves_row(global_model if override == "dense" else start)
                if not np.isfinite(decoded).all():
                    raise RuntimeError(f"edge {label}: non-finite reply")
                if sparse.is_sparse_payload(reply):
                    _check_reply(label, t, reply, decoded, delta + before if before is not None else delta,
                                 t.edge_residual)
                elif decoded.tobytes() != delta.tobytes():
                    raise RuntimeError(f"edge {label}: the dense reply does not decode to its delta")
                key = f"{layout_name} {override}"
                stats[key]["reply_bytes"].append(len(reply))
                stats[key]["decode_s"].append(decode_s)
                for part, secs in t.last_times.items():
                    stats[key][part].append(secs)
            if override == "dense":
                for t in trainers:
                    t.set_global(g_bytes)
        buf[EDGE_TRAINERS:] = buf[:EDGE_TRAINERS].repeat(NUM_CLIENTS // EDGE_TRAINERS - 1, 1)
        weights = torch.full((NUM_CLIENTS,), float(HOST_STEPS * BATCH), device="cuda")
        calls = _edge_server_calls(lay, gtree, buf, weights)
        for name, fn in calls.items():
            stats["server"][f"{layout_name} {name}_ms"].append(_time_ms(fn, runs=3, calls=1, own_syncs=True))
            out, _ = fn()
            if not all(bool(torch.isfinite(v).all()) for tree in out.values() for v in tree.values()):
                raise RuntimeError(f"edge {layout_name} {name}: non-finite global model")
        # The same functions on the CPU, on the 4 distinct rows.
        rows4 = buf[:EDGE_TRAINERS].contiguous()
        w4 = weights[:EDGE_TRAINERS].contiguous()
        gpu_calls = _edge_server_calls(lay, gtree, rows4, w4)
        cpu_calls = _edge_server_calls(
            lay, {c: {k: v.cpu() for k, v in tree.items()} for c, tree in gtree.items()}, rows4.cpu(), w4.cpu())
        for name in EDGE_SERVER:
            got, _ = gpu_calls[name]()
            want, _ = cpu_calls[name]()
            bad = sum(_beyond(got[c][k].cpu().numpy(), want[c][k].numpy()) for c in got for k in got[c])
            if bad:
                raise RuntimeError(f"edge {layout_name} {name}: {bad} coordinates differ from the CPU")
        trim = EDGE_SERVER["aggregate_krum"]["trim_fraction"]
        chosen = (_krum_choice(rows4, trim), _krum_choice(rows4.cpu(), trim))
        if chosen[0] != chosen[1] or chosen[0] < 0:
            raise RuntimeError(f"edge {layout_name} krum: the card chose row {chosen[0]}, the CPU {chosen[1]}")
        stats["server"][f"{layout_name} krum_choice"].append(chosen[0])
        del trainers, buf, calls, gpu_calls, cpu_calls
        gc.collect()
        torch.cuda.empty_cache()
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"edge: K1-K3 launched on the edge path: {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    for key, parts in stats.items():
        rec = {part: statistics.median(v) for part, v in parts.items()}
        rec["card"] = card
        log(f"edge {key}: " + json.dumps(rec))
    log("edge: " + json.dumps({"peak_mem_gb": peak, "launches": counts, "card": card}))
    return stats


# --------------------------------------------------------- 10. federation

FED_CLIENTS = 4  # port clients, ranks 0-3 of a world of 4, 256 examples each
# (layout, codec, server pipeline, rounds), after a dense round 0.
# int8 comes last: the deadline, failover and restart rounds run the last
# group's codec, and rotq's host encode and decode would triple their collect.
FED_GROUPS = (
    ("per_leaf", "none", "barrier", 1),
    ("per_leaf", "topk", "barrier", 1),
    ("flat", "rotq", "stream", 1),
    ("flat", "int8", "stream", 1),
)
FED_WATCHDOG_S = 2.0
FED_EVAL = 256  # examples each client evaluates a broadcast on
# The group whose primary and clients run under telemetry='trace'.
FED_TRACED = ("per_leaf", "topk")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fed_cfg(layout: str, codec: str, pipeline: str) -> RoundConfig:
    cfg = bench_cfg(codec, layout, "mobilenet", data_kw=dict(num_examples=FED_CLIENTS * HOST_STEPS * BATCH),
                    fed_kw=dict(server_pipeline=pipeline, ft_watchdog_timeout_s=FED_WATCHDOG_S))
    return dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, num_clients=FED_CLIENTS))


def _cpu_combine(cfg, lay, before: dict, replies, order, pipeline: str, round_idx: int) -> np.ndarray:
    """The round's combine on the CPU from the replies the primary got:
    each decoded into a row of the edge's layout against the round's
    global (``before``, a flax tree), then the same ``aggregation``
    function as the primary's pipeline; the new global as a host row."""
    rows = np.zeros((len(order), lay.padded), np.float32)
    weights = []
    like = dict(before, num_examples=np.zeros((), np.float32))
    for i, c in enumerate(order):
        data = replies[c]
        if sparse.is_sparse_payload(data):
            extra = sparse.decode_into_row(data, lay.sizes, rows[i])
        else:
            extra = wire.decode_into_row(data, like, before, rows[i])
        weights.append(float(extra["num_examples"]))
    g_row = np.zeros(lay.padded, np.float32)
    g_row[: lay.total] = _leaves_row(before)
    g = flat.unpack_tree(lay, torch.from_numpy(g_row))
    rows_t, w = torch.from_numpy(rows), torch.tensor(weights, dtype=torch.float32)
    if pipeline == "stream":
        new, _ = edge_aggregation.finalize_stream(cfg, lay, g, rows_t, w, ())
    else:
        stacked = {"params": {}, "batch_stats": {}}
        for name, leaf in flat.unpack_stacked(lay, rows_t).items():
            col, rest = name.split(".", 1)
            stacked[col][rest] = leaf
        new, _ = edge_aggregation.aggregate(cfg, g, stacked, w, (), round_idx)
    return flat.pack_tree(lay, new)[: lay.total].numpy()


def _one_process_client(agent, replies, lock) -> None:
    """Keep each reply a client sends, by lineage round, for the CPU's
    check of the round (the held-back client's late reply lands after its
    round was checked); and run one client's card work at a time. The
    clients share this process and its GIL: four clients training at once
    took a round's collect to 97 s where one at a time took 35 s (at 96
    local steps each, on an H100). Clients of a real federation are
    processes of their own."""
    t = agent.trainer
    train, install, evaluate = t.train_round, t.set_global, t.evaluate

    def logged(rank, world, trace_ctx=None, coord_round=-1, codec_override=None):
        with lock:
            out = train(rank, world, trace_ctx=trace_ctx, coord_round=coord_round, codec_override=codec_override)
        replies.setdefault(coord_round, {})[t.identity] = out
        return out

    def locked(fn):
        def call(*args, **kwargs):
            with lock:
                return fn(*args, **kwargs)
        return call

    t.train_round, t.set_global, t.evaluate = logged, locked(install), locked(evaluate)


def _check_fed_round(primary, rec, wall, before, agents, replies, label, card, stats, order=None,
                     receivers=FED_CLIENTS):
    """A committed round, checked: nobody lost, the new global within the
    slices' tolerance of the CPU's combine of the replies the round used
    (decoded against ``before``, the round's global), ``bytes_down`` the
    payloads' sizes, every client's installed model the primary's. A root's
    round names the clients behind its partials (``order``), may have
    lost an aggregator, and broadcasts to ``receivers`` aggregators."""
    lay = primary.layout
    r = rec["round"]
    if rec.get("aborted") or (order is None and not all(rec["alive"])):
        raise RuntimeError(f"federation {label}: round {r} aborted or lost a client: {rec}")
    got = _leaves_row(primary._host_model())
    if not np.isfinite(got).all():
        raise RuntimeError(f"federation {label}: non-finite global model")
    used = rec["participants"]
    if order is None:
        order = [c for c in primary.registry.clients if c in replies.get(r, {})]
    else:
        used = rec["clients_aggregated"]
    if len(order) != used or any(c not in replies.get(r, {}) for c in order):
        raise RuntimeError(f"federation {label}: {len(order)} replies logged, {used} used")
    want = _cpu_combine(primary.cfg, lay, before, replies[r], order, rec["pipeline"], r)
    bad = _beyond(got, want)
    if bad > 0.001 * want.size:
        raise RuntimeError(f"federation {label}: round {r}: {bad} of {want.size} coordinates differ from the CPU")
    expect = len(primary.model_bytes()) * receivers
    if primary.backup_stub is not None:
        expect += len(primary.replica_bytes())
    if rec["bytes_down"] != expect:
        raise RuntimeError(f"federation {label}: bytes_down {rec['bytes_down']}, payloads {expect}")
    for a in agents:
        if _leaves_row(a.trainer.host_model()).tobytes() != got.tobytes():
            raise RuntimeError(f"federation {label}: client {a.trainer.identity} holds another model")
    keys = ("t_collect_s", "t_decode_s", "t_h2d_s", "t_aggregate_s", "t_post_barrier_s",
            "bytes_up", "bytes_down", "participants", "stragglers", "pipeline")
    out = {"round": r, **{k: rec[k] for k in keys}, "wall_s": wall,
           "codec_bytes": rec["bytes_up_by_codec"], "cpu_beyond": bad, "card": card}
    log(f"federation {label} round {r}: " + json.dumps(out))
    stats.append(out)


def _fed_round(primary, agents, replies, label, card, stats, **check):
    before = primary._host_model()
    t0 = time.perf_counter()
    rec = primary.round()
    wall = time.perf_counter() - t0
    _check_fed_round(primary, rec, wall, before, agents, replies, label, card, stats, **check)
    return rec


def _check_primary_obs(primary, label: str) -> dict:
    """A primary's registry and flight ring against its round records: the
    rounds counter its committed rounds, ``fedtpu_rpc_bytes_up_total`` the
    sum of their ``bytes_up`` exactly, each phase histogram one count a
    round, one flight ``round`` event a committed round."""
    committed = [rec for rec in primary.history if not rec.get("aborted")]
    reg = primary.telemetry.registry
    phases = {e["labels"]["phase"]: e["count"] for e in reg.snapshot().get("fedtpu_round_phase_seconds", [])}
    events = [e["round"] for e in primary.flight.snapshot() if e["kind"] == "round"]
    out = {"rounds": _metric(reg, "fedtpu_rounds_completed_total"),
           "bytes_up": _metric(reg, "fedtpu_rpc_bytes_up_total"), "phases": phases, "flight_rounds": events}
    want = {"rounds": len(committed), "bytes_up": sum(rec["bytes_up"] for rec in committed),
            "phases": dict.fromkeys(("aggregate", "collect", "decode", "h2d"), len(committed)),
            "flight_rounds": [rec["round"] for rec in committed]}
    if out != want:
        raise RuntimeError(f"federation {label}: the registry and flight ring say {out}, the records {want}")
    return out


def _merged_parents(doc):
    """For each ``client_train`` of a merged trace: the name of its
    immediate parent and the (name, lane) of its root."""
    index = {e["args"]["span_id"]: e for e in doc["traceEvents"]
             if e.get("ph") == "X" and "span_id" in e.get("args", {})}
    out = []
    for e in index.values():
        if e["name"] != "client_train":
            continue
        parent = index.get(e["args"].get("parent_id"), {}).get("name")
        node, seen = e, set()
        while node["args"].get("parent_id") in index and node["args"]["span_id"] not in seen:
            seen.add(node["args"]["span_id"])
            node = index[node["args"]["parent_id"]]
        out.append((parent, node["name"], node["args"]["span_id"].split("/")[0]))
    return out


def _check_fed_trace(primary, agents, label: str) -> dict:
    """A traced group: every client's tracer holds the primary's trace id,
    its ``client_train`` spans name the primary as remote parent; each
    process's export, merged by ``tools/trace_merge.py --check`` (a
    subprocess: the tool is stdlib only), nests every client's
    ``client_train`` under a ``client_rpc`` and roots it at a ``round`` in
    the primary's lane."""
    import shutil
    import tempfile

    tid = primary.telemetry.tracer.trace_id
    root = tempfile.mkdtemp(prefix="fedtpu_torch_fedtrace_")
    try:
        paths = [os.path.join(root, "primary.json")]
        primary.telemetry.export_trace(paths[0])
        trains = 0
        for i, a in enumerate(agents):
            tel = a.trainer.telemetry
            if tel.tracer.trace_id != tid:
                raise RuntimeError(f"federation {label}: client {i} kept trace {tel.tracer.trace_id}, not {tid}")
            spans = [e["args"] for e in tel.trace_events() if e["name"] == "client_train"]
            if not spans or any(s.get("remote_role") != "primary" or not s.get("remote_parent", 0) > 0
                                for s in spans):
                raise RuntimeError(f"federation {label}: client {i}'s client_train spans {spans}")
            trains += len(spans)
            paths.append(os.path.join(root, f"client{i}.json"))
            tel.export_trace(paths[-1])
        merged = os.path.join(root, "merged.json")
        tool = Path(__file__).resolve().parent / "tools" / "trace_merge.py"
        run = subprocess.run([sys.executable, str(tool), *paths, "-o", merged, "--check"],
                             capture_output=True, text=True, timeout=120)
        if run.returncode != 0:
            raise RuntimeError(f"federation {label}: trace_merge --check failed: {run.stderr[-2000:]}")
        doc = json.loads(Path(merged).read_text())
        nested = _merged_parents(doc)
        if len(nested) != trains or any(n != ("client_rpc", "round", "primary") for n in nested):
            raise RuntimeError(f"federation {label}: merged client_train spans {nested}")
        out = {"trace_id": tid, "processes": len(paths), "client_train": trains,
               "merged_spans": sum(e.get("ph") == "X" for e in doc["traceEvents"]),
               "merged_bytes": os.path.getsize(merged), "dir": root}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"federation {label} trace: " + json.dumps(out) + " (removed)")
    return out


def federation_phase(data, card):
    """A federation over localhost gRPC on the card: a port PrimaryServer,
    a BackupServer and FED_CLIENTS serve_client MobileNet clients (HOST_STEPS
    steps of batch 128 in bf16, one shared copy of the data). A dense round 0,
    then FED_GROUPS' rounds (each group a primary started from the last
    one's replica, its clients restarted with the group's layout and
    codec), one round with a deadline that holds a client back, then the
    failover drill: the primary stops, the backup promotes and commits one
    round on the card, and a restarted primary demotes it and fetches its
    state, the round counter continuous. Each primary's registry and flight
    ring are held against its records (:func:`_check_primary_obs`), and the
    backup's flight recorder, in a temporary directory, must dump on the
    promotion. The FED_TRACED group runs under ``telemetry='trace'``, its
    traces merged and checked (:func:`_check_fed_trace`). No kernel of
    K1-K3 lies on this path: the counts are set to 0 before and must read
    0 after."""
    import shutil
    import tempfile

    # The phase runs over gRPC: its modules are imported here only.
    from fedtpu_torch.ft import Role
    from fedtpu_torch.obs import FlightRecorder
    from fedtpu_torch.transport.federation import BackupServer, PrimaryServer, serve_client

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    # Each client's shard of a world of 4 is one round's HOST_STEPS steps of 128.
    n = FED_CLIENTS * HOST_STEPS * BATCH
    data, eval_data = (data[0][:n], data[1][:n]), (data[0][:FED_EVAL], data[1][:FED_EVAL])
    backup_addr = f"localhost:{_free_port()}"
    flight_dir = tempfile.mkdtemp(prefix="fedtpu_torch_flight_")
    backup = BackupServer(_fed_cfg(*FED_GROUPS[-1][:3]), [], watchdog_timeout=FED_WATCHDOG_S,
                          flight=FlightRecorder(role="backup", artifacts_dir=flight_dir))
    backup_server = backup.start(backup_addr)
    stats, replies = [], {}
    servers, agents, state = [], [], None
    client_lock = threading.Lock()
    try:
        for gi, (layout, codec, pipeline, rounds) in enumerate(FED_GROUPS):
            cfg = _fed_cfg(layout, codec, pipeline)
            traced = (layout, codec) == FED_TRACED
            if traced:
                cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, telemetry="trace"))
            for s in servers:
                s.stop(0)
            servers, agents = [], []
            for k in range(FED_CLIENTS):
                server, agent = serve_client(f"localhost:{_free_port()}", cfg, seed=k, data=data,
                                             eval_data=eval_data)
                servers.append(server)
                agents.append(agent)
            addrs = [a.trainer.identity for a in agents]
            for a in agents:
                _one_process_client(a, replies, client_lock)
            primary = PrimaryServer(cfg, addrs, backup_address=backup_addr, initial_model=state)
            if state is not None:
                # The replica's roster names the last group's clients.
                for old in list(primary.registry.clients):
                    primary.remove_client(old)
                for addr in addrs:
                    primary.admit_client(addr)
            for _ in range(rounds + (1 if gi == 0 else 0)):
                _fed_round(primary, agents, replies, f"{layout} {codec}", card, stats)
            _check_primary_obs(primary, f"{layout} {codec}")
            if traced:
                _check_fed_trace(primary, agents, f"{layout} {codec}")
            state = primary.replica_bytes()
        # A deadline round: the last client held back past it.
        held = agents[-1].trainer
        hold_s = max(s["t_collect_s"] for s in stats[-2:]) + 2.0
        train = held.train_round
        held.train_round = lambda *a, **k: (time.sleep(hold_s + 2.0), train(*a, **k))[1]
        primary.round_deadline_s = hold_s
        rec = _fed_round(primary, agents, replies, f"{layout} {codec} deadline", card, stats)
        if rec["stragglers"] != 1 or rec["participants"] != FED_CLIENTS - 1 or not all(rec["alive"]):
            raise RuntimeError(f"federation: the held client is not a live straggler: {rec}")
        primary._inflight[held.identity].join(timeout=120)
        obs = {"primary": _check_primary_obs(primary, "deadline")}
        held.train_round = train
        primary.round_deadline_s = None
        primary.sync_clients()  # the straggler's late round is resynced
        # Failover: the primary's last ping arms the watchdog, then it stops.
        if primary.pinger.tick() is None:
            raise RuntimeError("federation: the backup does not answer the primary's ping")
        committed = {}

        def on_acting_round(r, rec):
            committed.setdefault("t", time.perf_counter())
            committed.setdefault("rec", rec)
            backup._acting_stop.set()

        backup.on_acting_round = on_acting_round
        before = primary._host_model()
        last = primary._round_counter
        t_stop = time.perf_counter()
        del primary
        deadline = time.perf_counter() + 120
        while "rec" not in committed and time.perf_counter() < deadline:
            time.sleep(0.05)
        if "rec" not in committed:
            raise RuntimeError("federation: the backup never committed an acting round")
        recover_s = committed["t"] - t_stop
        backup._promote_thread.join(timeout=120)
        acting = backup.acting
        if committed["rec"]["round"] != last or acting._role != 2 or acting._coord_epoch != 2:
            raise RuntimeError(f"federation: acting round {committed['rec']['round']} at epoch "
                               f"{acting._coord_epoch}, expected round {last} at epoch 2")
        _check_fed_round(acting, committed["rec"], committed["rec"]["t_round_s"], before, agents,
                         replies, "acting", card, stats)
        obs["acting"] = _check_primary_obs(acting, "acting")
        dump = json.loads(Path(backup.flight.dump_path()).read_text())
        if not dump["reason"].startswith("failover:") or dump["role"] != "backup":
            raise RuntimeError(f"federation: the backup's flight dump says {dump['reason']} ({dump['role']})")
        obs["backup_dump"] = {"path": backup.flight.dump_path(), "reason": dump["reason"],
                              "events": dump["num_events"]}
        log(f"federation: primary stopped -> first acting round committed in {recover_s:.3f} s ({card})")
        # The primary restarts: its recovering ping demotes the backup, it
        # fetches the acting state and runs on.
        before = acting._host_model()
        restarted = PrimaryServer(_fed_cfg(*FED_GROUPS[-1][:3]), addrs, backup_address=backup_addr)
        t0 = time.perf_counter()
        restarted.run(num_rounds=1)
        wall = time.perf_counter() - t0
        if backup.machine.role is not Role.BACKUP:
            raise RuntimeError("federation: the restarted primary did not demote the backup")
        if restarted._coord_epoch != acting._coord_epoch:
            raise RuntimeError("federation: the restarted primary did not adopt the acting epoch")
        _check_fed_round(restarted, restarted.history[-1], wall, before, agents, replies,
                         "restarted", card, stats)
        obs["restarted"] = _check_primary_obs(restarted, "restarted")
        log("federation obs: " + json.dumps(obs))
        rounds = [s["round"] for s in stats]
        if rounds != list(range(len(rounds))):
            raise RuntimeError(f"federation: the round counter is not continuous: {rounds}")
        del acting
        backup.acting = None
    finally:
        backup.watchdog.stop()
        backup._stop_acting(wait=60)
        backup_server.stop(0)
        for s in servers:
            s.stop(0)
        shutil.rmtree(flight_dir, ignore_errors=True)
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"federation: K1-K3 launched on the coordinator's path: {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # The coordinator's own footprint: its model and server state, and what
    # a stream round's buffer and combine add above what stays allocated
    # once the clients are gone.
    del agents, servers
    gc.collect()
    torch.cuda.empty_cache()
    lay = restarted.layout
    model_gb = sum(t.numel() * t.element_size() for tree in restarted.global_tree.values()
                   for t in tree.values()) / 1e9
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = torch.zeros((FED_CLIENTS, lay.padded), device="cuda")
    edge_aggregation.finalize_stream(restarted.cfg, lay, restarted.global_tree, rows,
                                     torch.ones(FED_CLIENTS, device="cuda"), ())
    torch.cuda.synchronize()
    combine_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    log("federation: " + json.dumps({
        "rounds": len(rounds), "time_to_recover_s": recover_s, "peak_mem_gb_process": peak,
        "coordinator_model_gb": model_gb, "coordinator_round_gb": combine_gb,
        "allocated_after_clients_gb": base / 1e9, "host_rss_gb": process_rss_bytes() / 1e9,
        "launches": counts, "card": card}))
    return counts


# -------------------------------------------------------------- 11. faults

# Phase 11's schedules: the primary's (seeded StartTrain errors and
# corruptions, SendModel delays), one client server's, and the attacker's.
FAULTS_PRIMARY_SPEC = (
    "error@StartTrain:p=0.3,consec=1;corrupt@StartTrain:p=0.25,consec=1;"
    "delay@SendModel:p=0.2,delay=0.2,seed=7"
)
FAULTS_CLIENT_SPEC = "error@SendModel:p=0.3,consec=1"
FAULTS_ATTACK_SPEC = "sign_flip@Attack:p=1"
# Two StartTrain rules of consec=1 can fail three attempts in a row.
FAULTS_RETRY = dict(max_attempts=4)
FAULTS_CHAOS_ROUNDS = 3
FAULTS_TIER_FANOUT = 2


def _faults_cfg(**fed_kw) -> RoundConfig:
    cfg = _fed_cfg("flat", "int8", "stream")
    return dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, retry=RetryPolicy(**FAULTS_RETRY), **fed_kw))


def _spy_attacker(t, seen, lock) -> None:
    """Keep, per lineage round, what the attacker held before its first
    try (the installed global and its residual) and after its last."""
    train = t.train_round

    def spied(rank, world, trace_ctx=None, coord_round=-1, codec_override=None):
        first = seen.setdefault(coord_round, {})
        if "start" not in first:
            with lock:
                first["start"] = _leaves_row(t.host_model())
            first["residual"] = None if t.edge_residual is None else _leaves_row(t.edge_residual)
        out = train(rank, world, trace_ctx=trace_ctx, coord_round=coord_round, codec_override=codec_override)
        with lock:
            first.update(after=_leaves_row(t.host_model()), left=t.edge_residual, reply=out)
        return out

    t.train_round = spied


def _check_attacker(t, seen, r, label) -> float:
    """The attacker's round-``r`` reply: its int8 row is the negation of
    its honest delta (its own state after the round minus the start),
    formed as fedtpu forms it (start + (-delta) - start, in f32), plus the
    residual carried in, within int8's half step; returns the cosine of
    the decoded row with the honest delta."""
    got = seen[r]
    honest = got["after"] - got["start"]
    x = (got["start"] + np.float32(-1.0) * honest) - got["start"]
    if got["residual"] is not None:
        x = x + got["residual"]
    decoded = np.zeros(t.layout.padded, np.float32)
    sparse.decode_into_row(got["reply"], t.layout.sizes, decoded)
    decoded = decoded[: t.layout.total]
    _check_reply(label, t, got["reply"], decoded, x, got["left"])
    cos = float(np.dot(decoded.astype(np.float64), honest) /
                (np.linalg.norm(decoded) * np.linalg.norm(honest) + 1e-30))
    if not cos < -0.9:
        raise RuntimeError(f"faults {label}: the attacker's row is not the negated delta (cos {cos:.4f})")
    return cos


def faults_phase(data, card):
    """The coordinator's fault injection, membership gate, adaptive codec
    policy and two tiers on the card over localhost gRPC, as the module
    docstring's phase 11 says. Returns the launch counts (all 0)."""
    from fedtpu_torch.ft import parse_chaos_spec
    from fedtpu_torch.transport.aggregator import serve_aggregator
    from fedtpu_torch.transport import proto
    from fedtpu_torch.transport.codec_policy import DEFAULT_CANDIDATES
    from fedtpu_torch.transport.federation import BackupServer, PrimaryServer, serve_client
    from fedtpu_torch.transport.service import TrainerStub, announce_join, announce_leave, create_channel

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    n = FED_CLIENTS * HOST_STEPS * BATCH
    data, eval_data = (data[0][:n], data[1][:n]), (data[0][:FED_EVAL], data[1][:FED_EVAL])
    cfg = _faults_cfg()
    stats, replies, seen = [], {}, {}
    client_lock = threading.Lock()
    servers, agents = [], []
    chaos = parse_chaos_spec(FAULTS_PRIMARY_SPEC)
    client_chaos = parse_chaos_spec(FAULTS_CLIENT_SPEC)
    backup_addr = f"localhost:{_free_port()}"
    backup = BackupServer(cfg, [], watchdog_timeout=3600.0)
    backup_server = backup.start(backup_addr)
    closers = [lambda: backup_server.stop(0), backup.watchdog.stop]
    try:
        # ---- (a) chaos
        t0 = time.perf_counter()
        for k in range(FED_CLIENTS):
            sched = {1: client_chaos, FED_CLIENTS - 1: parse_chaos_spec(FAULTS_ATTACK_SPEC)}.get(k)
            server, agent = serve_client(f"localhost:{_free_port()}", cfg, seed=k, data=data,
                                         eval_data=eval_data, chaos=sched)
            servers.append(server)
            agents.append(agent)
        addrs = [a.trainer.identity for a in agents]
        for a in agents:
            _one_process_client(a, replies, client_lock)
        attacker = agents[-1].trainer
        _spy_attacker(attacker, seen, client_lock)
        primary = PrimaryServer(cfg, addrs, backup_address=backup_addr, chaos=chaos)
        cosines = []
        for _ in range(FAULTS_CHAOS_ROUNDS):
            rec = _fed_round(primary, agents, replies, "chaos", card, stats)
            if rec["participants"] != FED_CLIENTS:
                raise RuntimeError(f"faults chaos: a fault cost a client its round: {rec}")
            if rec["round"] > 0:  # round 0's replies are dense: the clients were not synced
                cosines.append(_check_attacker(attacker, seen, rec["round"], f"attacker round {rec['round']}"))
        errors, corrupts = chaos._fired[0], chaos._fired[1]
        retried = _metric(primary.telemetry.registry, "fedtpu_rpc_retries_total", rpc="StartTrain")
        if retried != errors + corrupts or chaos.injected_total() == 0:
            raise RuntimeError(f"faults chaos: {retried} StartTrain retries for {errors} errors "
                               f"and {corrupts} corruptions")
        sent_retried = _metric(primary.telemetry.registry, "fedtpu_rpc_retries_total", rpc="SendModel")
        if sent_retried != client_chaos.injected_total():
            raise RuntimeError(f"faults chaos: {sent_retried} SendModel retries for "
                               f"{client_chaos.injected_total()} client-side errors")
        log("faults chaos: " + json.dumps({
            "rounds": FAULTS_CHAOS_ROUNDS, "injected": chaos.injected_total(), "start_train_errors": errors,
            "corrupt_replies": corrupts, "start_train_retries": retried,
            "send_model_delays": chaos._fired[2], "client_send_model_errors": client_chaos.injected_total(),
            "send_model_retries": sent_retried, "attacker_cosines": cosines,
            "seconds": time.perf_counter() - t0, "card": card}))

        # ---- (b) the membership gate
        t0 = time.perf_counter()
        gate = f"localhost:{_free_port()}"
        primary.start_gate(gate)
        closers.append(primary.stop_gate)
        server, joiner = serve_client(f"localhost:{_free_port()}", cfg, seed=FED_CLIENTS, data=data,
                                      eval_data=eval_data)
        servers.append(server)
        _one_process_client(joiner, replies, client_lock)
        version = primary.registry.version
        stub = announce_join(gate, joiner.trainer.identity, timeout_s=60.0)
        if stub is None or not primary.registry.is_alive(joiner.trainer.identity) or not joiner.trainer.synced:
            raise RuntimeError("faults gate: the joiner was not admitted and resynced")
        if primary.registry.version != version + 1 or primary.registry.seat_of(joiner.trainer.identity) != FED_CLIENTS:
            raise RuntimeError(f"faults gate: version {primary.registry.version}, seat "
                               f"{primary.registry.seat_of(joiner.trainer.identity)}")
        rec = _fed_round(primary, agents + [joiner], replies, "gate join", card, stats,
                         receivers=FED_CLIENTS + 1)
        if rec["participants"] != FED_CLIENTS + 1 or rec["world"] != FED_CLIENTS + 1:
            raise RuntimeError(f"faults gate: the joiner did not train the next round: {rec}")
        if not announce_leave(stub, joiner.trainer.identity) or primary.registry.version != version + 2:
            raise RuntimeError("faults gate: the Leave did not evict the joiner")
        rec = _fed_round(primary, agents, replies, "gate leave", card, stats)
        if rec["participants"] != FED_CLIENTS:
            raise RuntimeError(f"faults gate: {rec['participants']} participants after the leave")
        bstub = TrainerStub(create_channel(backup_addr))
        reply = bstub.Join(proto.JoinRequest(address=b"localhost:1"), timeout=30)
        if (reply.admitted, reply.message) != (0, b"not primary"):
            raise RuntimeError(f"faults gate: the backup answered Join {reply}")
        primary.stop_gate()
        log("faults gate: " + json.dumps({
            "versions": [version, version + 1, version + 2], "joiner_seat": FED_CLIENTS,
            "backup_join": reply.message.decode(), "seconds": time.perf_counter() - t0, "card": card}))

        # ---- (c) the adaptive codec policy
        t0 = time.perf_counter()
        adaptive = PrimaryServer(_faults_cfg(codec_policy="adaptive"), addrs, initial_model=primary.replica_bytes())
        chosen = []
        for r in range(len(DEFAULT_CANDIDATES) + 1):
            costs = adaptive._codec_policy.snapshot()
            want = [adaptive._codec_policy.choose(adaptive.registry.seat_of(c)) for c in addrs]
            rec = _fed_round(adaptive, agents, replies, "adaptive", card, stats)
            used = sorted(rec["bytes_up_by_codec"])
            chosen.append(want)
            if r < len(DEFAULT_CANDIDATES):
                if want != [DEFAULT_CANDIDATES[r]] * FED_CLIENTS or used != [DEFAULT_CANDIDATES[r]]:
                    raise RuntimeError(f"faults adaptive: warmup round {r} asked {want}, used {used}")
            elif sorted(set(want)) != used:
                raise RuntimeError(f"faults adaptive: round {r} asked {want}, used {used}")
        seen_codecs = sorted(adaptive._codec_bytes_up)
        if seen_codecs != sorted(DEFAULT_CANDIDATES):
            raise RuntimeError(f"faults adaptive: bytes_up_by_codec saw {seen_codecs}")
        log("faults adaptive: " + json.dumps({
            "chosen": chosen, "costs_before_last": costs, "codec_bytes_up": adaptive._codec_bytes_up,
            "seconds": time.perf_counter() - t0, "card": card}))

        # ---- (d) two tiers
        t0 = time.perf_counter()
        tier_cfg = _faults_cfg(tier_fanout=FAULTS_TIER_FANOUT, round_quorum=0.5)
        # The lineage goes on without the flat roster: the aggregators take
        # seats 0 and 1, so the root's world is 2 x 2 (ranks 0-3, 256
        # examples each, as in (a)-(c)).
        root = PrimaryServer(tier_cfg, [])
        state = adaptive.state_tree()
        del state["membership"]
        root.install_state(state)
        gate = f"localhost:{_free_port()}"
        root.start_gate(gate)
        closers.append(root.stop_gate)
        aggs = []
        for j in range(2):
            cohort = addrs[j * FAULTS_TIER_FANOUT:(j + 1) * FAULTS_TIER_FANOUT]
            aggs.append(serve_aggregator(f"localhost:{_free_port()}", tier_cfg, clients=cohort, parent=gate))
            closers += [lambda s=aggs[-1][0]: s.stop(0), aggs[-1][1].monitor.stop]
        if root.registry.clients != [a.identity for _, a in aggs]:
            raise RuntimeError(f"faults tiers: the root's roster is {root.registry.clients}")
        partials = []
        for _ in range(2):
            rec = _fed_round(root, agents, replies, "tiers", card, stats, order=addrs, receivers=2)
            partials.append({a.identity: a._last_partial for _, a in aggs})
            if rec["participants"] != 2 or rec["clients_aggregated"] != FED_CLIENTS or rec["world"] != FED_CLIENTS:
                raise RuntimeError(f"faults tiers: {rec}")
        aggs[1][0].stop(0)
        rec = _fed_round(root, agents[:FAULTS_TIER_FANOUT], replies, "tiers, one aggregator stopped", card, stats,
                         order=addrs[:FAULTS_TIER_FANOUT], receivers=1)
        if rec["participants"] != 1 or rec["alive"] != [True, False]:
            raise RuntimeError(f"faults tiers: the stopped aggregator's row was not masked: {rec}")
        partials.append({aggs[0][1].identity: aggs[0][1]._last_partial})
        log("faults tiers: " + json.dumps({
            "partials": partials, "root_buffer_bytes": rec["buffer_bytes"],
            "seconds": time.perf_counter() - t0, "card": card}))
    finally:
        for close in reversed(closers):
            close()
        for s in servers:
            s.stop(0)
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"faults: K1-K3 launched on the coordinator's path: {counts}")
    log("faults: " + json.dumps({"rounds": len(stats), "seconds": time.perf_counter() - t_phase,
                                 "launches": counts, "card": card}))
    return counts


# ------------------------------------------------------------------ 12. zoo

# BASELINE config 4 (bench_parity.py:100-124): FedAvg ResNet-18 on CIFAR-100,
# 64 clients, batch 128, iid, lr 0.05 constant, augmentation; a local epoch
# of a 781-example shard is its 6 whole batches. The plain round fits an
# 80 GB card, and remat (fedtpu's switch for this config on a 16 GB v5e)
# does not lower its peak: config 4 runs without remat, and phase 12 prints
# both peaks.
ZOO_CLIENTS = 64
ZOO_CLASSES = 100
ZOO_EPOCHS = 2  # local epochs of config 4's multi-epoch round (5 before phase 16)
ZOO_CASES = [("none", "per_leaf"), ("topk", "per_leaf"), ("int8", "per_leaf"), ("rotq", "flat")]
ZOO_TIMED_ROUNDS = 1  # as MOBILENET_TIMED_ROUNDS
# densenet_cifar has no remat in fedtpu, and its concatenations make its
# activations at 64 clients of batch 128 several times the card's memory
# (phase 12 prints its peak at 8), so its rounds run 8 clients.
DENSENET_CLIENTS = 8
DENSENET_CASES = [("topk", "per_leaf"), ("int8", "per_leaf")]
DENSENET_ROUNDS = 2
BF16_PEAK = 989e12  # H100 SXM dense bf16, NVIDIA's data sheet


def zoo_cfg(model, codec, layout, clients=ZOO_CLIENTS, classes=ZOO_CLASSES, epochs=1, remat=False):
    """BASELINE config 4's round (``model`` in place of ResNet-18 for
    DenseNet), with the update codec switched on."""
    return RoundConfig(
        model=model,
        num_classes=classes,
        opt=OptimizerConfig(learning_rate=0.05, schedule="constant"),
        data=DataConfig(dataset="cifar100" if classes == 100 else "cifar10", batch_size=BATCH,
                        partition="iid", augment=True),
        fed=FedConfig(num_clients=clients, compression=codec, topk_fraction=TOPK_FRACTION,
                      delta_layout=layout, local_epochs=epochs),
        steps_per_round=STEPS,
        dtype="bfloat16",
        remat=remat,
    )


def _zoo_small_cfg(model, codec, layout, dataset, clients, batch):
    return RoundConfig(
        model=model,
        num_classes=datasets.dataset_info(dataset)[1],
        data=DataConfig(dataset=dataset, batch_size=batch, partition="iid", augment=False),
        fed=FedConfig(num_clients=clients, compression=codec, delta_layout=layout),
        steps_per_round=2,
    )


# (model, dataset, image size, clients, batch, f64, cases): the zoo's small
# rounds, card against CPU. MLP (BASELINE config 1: 2 clients, iid) and
# LeNet are held in f32. The BatchNorm models keep the global model in f64,
# as the MobileNet reference does: two f32 rounds of VGG11 (8 BatchNorms
# over 8-example batches) on the card and on the CPU part on most of their
# coordinates. The ResNets and DenseNet run at small images (the global
# pool makes the size free; the last map still holds 4 values a channel),
# VGG11 at its own 32x32.
ZOO_REFERENCE = [
    ("mlp", "mnist", (28, 28, 1), 2, 8, False, [("none", "per_leaf"), ("topk", "per_leaf")]),
    ("lenet", "cifar10", (32, 32, 3), 4, 8, False, [("none", "per_leaf"), ("int8", "per_leaf")]),
    ("vgg11", "cifar10", (32, 32, 3), 4, 4, True, [("none", "per_leaf")]),
    ("resnet18", "cifar100", (8, 8, 3), 4, 4, True, [("none", "per_leaf"), ("rotq", "flat")]),
    ("preactresnet18", "cifar10", (8, 8, 3), 4, 4, True, [("none", "per_leaf")]),
    ("densenet_cifar", "cifar10", (16, 16, 3), 4, 4, True, [("none", "per_leaf"), ("topk", "per_leaf")]),
]


def zoo_reference_phase():
    """Phase 12 (a): small rounds of every zoo family on the card against
    the CPU, one round each (two in f32), within the reference tolerance
    (rotq's params at 2e-4, as MobileNet's)."""
    rng = np.random.default_rng(12)
    for model, dataset, size, clients, batch, f64, cases in ZOO_REFERENCE:
        classes = datasets.dataset_info(dataset)[1]
        n = clients * 2 * batch
        if dataset == "mnist":
            data = datasets.load("mnist", "train", seed=0, num=n)
        else:
            data = (rng.standard_normal((n,) + size, dtype=np.float32),
                    rng.integers(0, classes, size=n).astype(np.int32))
        mask = torch.ones((clients, 2), dtype=torch.bool)
        mask[1, 1] = False  # client 1's second step is padding
        for codec, layout in cases:
            card_vs_cpu(
                f"zoo reference: {model} {layout} {codec}", _zoo_small_cfg(model, codec, layout, dataset, clients, batch),
                data, codec, rounds=1 if f64 else 2, params_atol=2e-4 if codec == "rotq" else 1e-5,
                f64=f64, step_mask=mask if f64 else None,
            )


def _free() -> None:
    """Drop the engines no one holds. Their device memory stays in the
    caching allocator for the next engine (the allocator hands it back to
    the driver itself if a request needs it): with the cache emptied in
    between, the next config-4 or ShuffleNetV2 engine's first round took
    0.6-1.2 s longer."""
    gc.collect()


def zoo_phase(data, card, profile_dir=None):
    """Phase 12 (b)-(c): BASELINE config 4 at full width, then
    densenet_cifar at 8 clients, both on CIFAR-100 shapes. The launch
    counts are set to 0 before the first checked round and read after the
    last: 2 rounds each of ResNet-18 per leaf none (no launch), topk (1
    K1), int8 (1 K2) and flat rotq (2 K3), round 1's codec re-applied with
    the plain kernels; the uncompressed engine then times 2 rounds and
    runs one more under the profiler (the device's idle share); then 2
    rounds each of DenseNet per leaf topk (5 K1) and int8 (5 K2). Last,
    a round with remat (for its memory) and one of ZOO_EPOCHS local
    epochs (config 4's local work is 5), each an engine's first (its time includes the
    upload of the data). Returns the results and the
    path's counts."""
    _free()
    out = {"card": card}
    flops = model_flops("resnet18", ZOO_CLASSES, ZOO_CLIENTS * STEPS * BATCH)
    kernels.reset_launch_counts()
    for model, cases, clients, leaves, rounds in (
        ("resnet18", ZOO_CASES, ZOO_CLIENTS, RESNET18_LEAVES, CHECK_ROUNDS),
        ("densenet_cifar", DENSENET_CASES, DENSENET_CLIENTS, DENSENET_LEAVES, DENSENET_ROUNDS),
    ):
        codecs = slice_codecs(leaves)
        for codec, layout in cases:
            counted, per_round, make_plain = codecs[(codec, layout)]
            cfg = zoo_cfg(model, codec, layout, clients)
            rec = Recorder(compression.make_compressor(cfg.fed)) if make_plain else None
            fed = Federation(cfg, seed=0, data=data, compressor=rec.compressor() if rec else None)
            tag = f"zoo {model} {clients} clients {layout} {codec}"
            # The uncompressed case has no codec to re-apply at round 1: its
            # one checked round warms the engine for the timed one.
            records = check_rounds(fed, tag, codec, layout, counted, per_round, rec, make_plain,
                                   rounds=1 if codec == "none" else rounds, peak=True)
            out[f"{model} {layout} {codec}"] = {"clients": clients, "rounds": records}
            if (model, codec) == ("resnet18", "none"):
                out["timed"] = _zoo_timing(fed, flops, card, ZOO_CLIENTS, "config 4 resnet18")
                _, out["idle_share"] = profile_phase(fed, profile_dir, "zoo_resnet18_per_leaf_none", rounds=1,
                                                    warm=False)
            del fed, rec
            _free()
    counts = _launch_counts()
    for label, kw in (("remat", dict(remat=True)), (f"local_epochs_{ZOO_EPOCHS}", dict(epochs=ZOO_EPOCHS))):
        fed = Federation(zoo_cfg("resnet18", "none", "per_leaf", **kw), seed=0, data=data)
        records = check_rounds(fed, f"zoo resnet18 per_leaf none, {label}", "none", "per_leaf", None, 0,
                               rounds=1, peak=True)
        secs = records[-1]["round_s"]
        epochs = kw.get("epochs", 1)
        out[label] = {
            "first_round": True, "round_s": secs, "rounds_per_s": 1 / secs,
            "client_epochs_per_s": ZOO_CLIENTS * epochs / secs,
            "model_tflop_per_round": flops * epochs / 1e12,
            "mfu_bf16": flops * epochs / secs / BF16_PEAK,
            "peak_gb": max(r["peak_gb"] for r in records), "card": card,
        }
        log(f"zoo: config 4 resnet18 {label}: " + json.dumps(out[label]))
        del fed
        _free()
    log(f"zoo: device idle share of a config-4 round {out['idle_share']:.4f} | {card}")
    return out, counts


def _zoo_timing(fed, flops, card, clients, label):
    """ZOO_TIMED_ROUNDS rounds of an engine of ``clients`` clients after
    its checked rounds: rounds/s, client-epochs/s and MFU against the bf16
    peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = fed.run_on_device(ZOO_TIMED_ROUNDS)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / ZOO_TIMED_ROUNDS
    if not torch.isfinite(m.loss).all():
        raise RuntimeError(f"zoo timing: non-finite loss {m.loss.tolist()}")
    result = {
        "rounds": ZOO_TIMED_ROUNDS, "round_s": secs, "rounds_per_s": 1 / secs,
        "client_epochs_per_s": clients / secs, "model_tflop_per_round": flops / 1e12,
        "mfu_bf16": flops / secs / BF16_PEAK, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"zoo: {label} per_leaf none, timed: " + json.dumps(result))
    return result


# ------------------------------------------------------ 13. zoo, part 2a

# The flagship round's traffic (bench_cfg: CIFAR-10 shapes, batch 128, 6
# local steps, iid, presharded, bf16) on the zoo's second part. ShuffleNetV2
# runs all 64 clients; MobileNetV2's activations (three times
# ShuffleNetV2's conv outputs an image) would need some 150 GB at 64, 8
# times its 8-client peak, so it runs 16. Phase 13 prints each model's
# peak at 8 clients and its linear extrapolation to the clients it runs,
# before it runs them.
SHUFFLENETV2_CLIENTS = 64
MOBILENETV2_CLIENTS = 16
PROBE_CLIENTS = 8
ZOO2_ROUNDS = CHECK_ROUNDS  # checked rounds a codec
MOBILENETV2_CASES = [("topk", "per_leaf"), ("int8", "per_leaf")]

# (model, image size, cases): phase 13 (a)'s small rounds, card against
# CPU, the global model in f64 (4 clients, batch 4, one step masked). The
# images leave at least 4 values a channel in the last map.
ZOO2_REFERENCE = [
    ("mobilenetv2", (16, 16, 3), [("none", "per_leaf")]),
    ("shufflenetg3", (16, 16, 3), [("none", "per_leaf")]),
    ("shufflenetv2", (16, 16, 3), [("none", "per_leaf")]),
    ("googlenet", (8, 8, 3), [("none", "per_leaf")]),
    ("resnext29_2x64d", (8, 8, 3), [("none", "per_leaf")]),
    ("senet18", (8, 8, 3), [("none", "per_leaf")]),
    ("dpn26", (8, 8, 3), [("none", "per_leaf"), ("topk", "per_leaf")]),
]


def zoo2_reference_phase():
    """Phase 13 (a): a small round of every family of the zoo's second
    part on the card against the CPU, within the reference tolerance."""
    rng = np.random.default_rng(13)
    clients, batch = 4, 4
    mask = torch.ones((clients, 2), dtype=torch.bool)
    mask[1, 1] = False  # client 1's second step is padding
    for model, size, cases in ZOO2_REFERENCE:
        n = clients * 2 * batch
        data = (rng.standard_normal((n,) + size, dtype=np.float32),
                rng.integers(0, 10, size=n).astype(np.int32))
        for codec, layout in cases:
            card_vs_cpu(
                f"zoo2 reference: {model} {layout} {codec}",
                _zoo_small_cfg(model, codec, layout, "cifar10", clients, batch),
                data, codec, f64=True, step_mask=mask,
            )


def _peak_probe(model, data, clients, card):
    """One uncompressed flagship round of ``model`` at PROBE_CLIENTS
    clients (after a first round): its peak, and that peak scaled linearly
    to ``clients``."""
    fed = Federation(bench_cfg("none", model=model, clients=PROBE_CLIENTS), seed=0, data=data)
    fed.run_on_device(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed.run_on_device(1)
    torch.cuda.synchronize()
    out = {"clients": PROBE_CLIENTS, "round_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out[f"peak_gb_scaled_to_{clients}"] = out["peak_gb"] * clients / PROBE_CLIENTS
    out["card"] = card
    log(f"zoo: {model} memory probe: " + json.dumps(out))
    del fed
    _free()
    return out


def zoo2_phase(data, card, profile_dir=None):
    """Phase 13 (b)-(c): ShuffleNetV2 at full width over 64 clients, then
    MobileNetV2 at 16, on the flagship round's data. First each model's
    memory probe; then the launch counts are set to 0 before the first
    checked round and read after the last: 2 rounds each of ShuffleNetV2
    per leaf none (no launch), topk (3 K1), int8 (2 K2) and flat rotq (2 K3
    over [64, 2^21]), round 1's codec re-applied with the plain kernels;
    the uncompressed engine then times 2 rounds and runs one more under
    the profiler (the device's idle share); then 2 rounds each of
    MobileNetV2 per leaf topk (3 K1) and int8 (2 K2). Returns the results
    and the path's counts."""
    _free()
    out = {"card": card}
    for model, clients in (("shufflenetv2", SHUFFLENETV2_CLIENTS), ("mobilenetv2", MOBILENETV2_CLIENTS)):
        out[f"{model} probe"] = _peak_probe(model, data, clients, card)
    flops = model_flops("shufflenetv2", 10, SHUFFLENETV2_CLIENTS * STEPS * BATCH)
    peaks_gb = {}
    kernels.reset_launch_counts()
    for model, cases, clients, leaves, rounds in (
        ("shufflenetv2", ZOO_CASES, SHUFFLENETV2_CLIENTS, SHUFFLENETV2_LEAVES, ZOO2_ROUNDS),
        ("mobilenetv2", MOBILENETV2_CASES, MOBILENETV2_CLIENTS, MOBILENETV2_LEAVES, ZOO2_ROUNDS),
    ):
        codecs = slice_codecs(leaves)
        for codec, layout in cases:
            counted, per_round, make_plain = codecs[(codec, layout)]
            t0 = time.perf_counter()
            cfg = bench_cfg(codec, layout, model, clients=clients)
            rec = Recorder(compression.make_compressor(cfg.fed)) if make_plain else None
            fed = Federation(cfg, seed=0, data=data, compressor=rec.compressor() if rec else None)
            tag = f"zoo2 {model} {clients} clients {layout} {codec}"
            t_built = time.perf_counter()
            records = check_rounds(fed, tag, codec, layout, counted, per_round, rec, make_plain,
                                   rounds=1 if codec == "none" else rounds, peak=True)
            out[tag] = {"clients": clients, "rounds": records}
            peaks_gb[tag] = max(r["peak_gb"] for r in records)
            t_checked = time.perf_counter()
            if (model, codec) == ("shufflenetv2", "none"):
                out["timed"] = _zoo_timing(fed, flops, card, clients, f"zoo2 {model} {clients} clients")
                _, out["idle_share"] = profile_phase(fed, profile_dir, "zoo2_shufflenetv2_per_leaf_none",
                                                    rounds=1, warm=False)
            del fed, rec
            _free()
            log(f"clock: {tag}: engine {t_built - t0:.1f} s, checked rounds {t_checked - t_built:.1f} s, "
                f"timing and profile {time.perf_counter() - t_checked:.1f} s")
    counts = _launch_counts()
    log(f"zoo2: peaks {json.dumps(peaks_gb)}; device idle share of a ShuffleNetV2 round "
        f"{out['idle_share']:.4f} | {card}")
    return out, counts


# ------------------------------------------------------ 14. zoo, part 2b

# (model, image size, cases): phase 14 (a)'s small rounds, card against
# CPU, the global model in f64 (4 clients, batch 4, one step masked). The
# images leave at least 2x2 in the last map.
ZOO3_REFERENCE = [
    ("efficientnetb0", (32, 32, 3), [("none", "per_leaf")]),
    ("regnetx_200mf", (8, 8, 3), [("none", "per_leaf")]),
    ("regnetx_400mf", (8, 8, 3), [("none", "per_leaf")]),
    ("regnety_400mf", (8, 8, 3), [("none", "per_leaf"), ("topk", "per_leaf")]),
    ("pnasneta", (8, 8, 3), [("none", "per_leaf")]),
    ("pnasnetb", (8, 8, 3), [("none", "per_leaf")]),
    ("dla", (16, 16, 3), [("none", "per_leaf")]),
    ("simpledla", (16, 16, 3), [("none", "per_leaf")]),
]
# The small rounds take one local step a client. The loss is computed in
# f32 (fedtpu casts the logits), and CUDA's and the CPU's f32 log-softmax
# part in the last bits; after a first step the 400MF RegNets' logits
# saturate, and their second step turns those bits into far-apart
# coordinates (RegNetY-400MF's two-step rounds parted on 29% of them, and
# RegNetX-400MF's on 10% at lr 0.01, while their f64 logits and gradients
# agree to 1e-13 on the two devices; an f64 loss on the CPU parts from the
# f32 one the same way). A round of one step depends on the gradient at
# init alone.
ZOO3_REFERENCE_STEPS = 1
ZOO3_MAX_GB = 75.0  # a cut's limit for the probe's peak scaled to the clients
ZOO3_CLIENT_COUNTS = (64, 32, 16)
ZOO3_ROUNDS = CHECK_ROUNDS  # checked rounds a codec
# Keep shares of the drawn masks: (module, its keep probability).
ZOO3_KEEP = (("MBConv_14", 0.825), ("Dropout_0", 0.8))
ZOO3_KEEP_TOLERANCE = 0.02


def _numpy_masks(model, clients, batch, steps):
    """``RoundDraws.dropout_masks``: keep masks drawn once on the CPU per
    round from a seeded generator, so that the card's and the CPU's rounds
    drop the same examples and entries."""
    with torch.device("meta"):
        specs = mask_specs(models.create(model))
    return lambda round_idx: draw_masks(specs, (clients, steps, batch),
                                        torch.Generator().manual_seed(1400 + round_idx))


ZOO3_GRADIENT_RTOL = 1e-10  # the card's f64 logits and gradients against the CPU's


def _f64_gradient_check(model, size, clients=2, batch=4):
    """Two clients' train-mode logits and loss gradients of ``model`` under
    ``vmap(grad)``, in f64 from one init, on the card against the CPU:
    their largest difference relative to the tensor's largest value, which
    must stay under ZOO3_GRADIENT_RTOL."""
    torch.manual_seed(0)
    m = models.create(model, 10, size).double()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((clients, batch) + size, generator=g, dtype=torch.float64)
    y = torch.randint(0, 10, (clients, batch), generator=g)
    masks = draw_masks(mask_specs(m), (clients, batch), g)

    def loss(p, s, x, y, masks):
        kwargs = {"train": True, "masks": masks} if masks else {"train": True}
        logits, _ = torch.func.functional_call(m, (p, s), (x,), kwargs)
        return torch.nn.functional.cross_entropy(logits, y), logits

    out = {}
    for dev in ("cpu", "cuda"):
        stack = lambda tree: {k: v.detach().expand((clients,) + v.shape).to(dev) for k, v in tree}
        args = (stack(m.named_parameters()), stack(m.named_buffers()), x.to(dev), y.to(dev),
                {k: v.to(dev) for k, v in masks.items()})
        out[dev] = torch.func.vmap(torch.func.grad(loss, has_aux=True))(*args)
    (g_cpu, l_cpu), (g_card, l_card) = out["cpu"], out["cuda"]
    # Differences scaled by the largest value of the logits, or of the
    # whole gradient: a leaf's own gradient can be all but 0.
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    diffs = {k: float((g_card[k].cpu() - v).abs().max()) / scale for k, v in g_cpu.items()}
    diffs["logits"] = float((l_card.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
    worst = max(diffs, key=diffs.get)
    if not diffs[worst] < ZOO3_GRADIENT_RTOL:
        raise RuntimeError(f"zoo3: {model}'s f64 {worst} on the card differs from the CPU's by "
                           f"{diffs[worst]:.3g} of its scale")
    log(f"zoo3 reference: {model} f64 logits and gradient under vmap, card vs CPU: largest difference "
        f"{diffs[worst]:.3g} of the scale ({worst})")
    return diffs[worst]


def zoo3_reference_phase():
    """Phase 14 (a): every name of the zoo's last part, its f64 logits and
    gradient under ``vmap`` on the card against the CPU's within
    ZOO3_GRADIENT_RTOL, then a small round on the card against the CPU's
    within the reference tolerance, of ZOO3_REFERENCE_STEPS local steps."""
    rng = np.random.default_rng(14)
    clients, batch, steps = 4, 4, ZOO3_REFERENCE_STEPS
    mask = torch.ones((clients, steps), dtype=torch.bool)
    mask[1, -1] = False  # client 1's last step is padding
    for model, size, cases in ZOO3_REFERENCE:
        n = clients * 2 * batch
        data = (rng.standard_normal((n,) + size, dtype=np.float32),
                rng.integers(0, 10, size=n).astype(np.int32))
        draws = RoundDraws(dropout_masks=_numpy_masks(model, clients, batch, steps))
        _f64_gradient_check(model, size)
        for codec, layout in cases:
            cfg = dataclasses.replace(_zoo_small_cfg(model, codec, layout, "cifar10", clients, batch),
                                      steps_per_round=steps)
            card_vs_cpu(f"zoo3 reference: {model} {layout} {codec}", cfg, data, codec, f64=True,
                        step_mask=mask, draws=draws)


def _keep_shares(fed, before):
    """The share of True in the keep masks a round of ``fed`` drew from
    its generator, whose state before the round was ``before``: the step
    draws its masks first (``core/client.py``), so the same draws from the
    same state are the round's."""
    g = torch.Generator(fed.device)
    g.set_state(before)
    specs = mask_specs(fed.model)
    n, batch = fed.cfg.fed.num_clients, fed.cfg.data.batch_size
    masks = draw_masks(specs, (n, STEPS, batch), g, fed.device)
    shares = {name: float(masks[name].float().mean()) for name, _ in ZOO3_KEEP}
    for name, keep in ZOO3_KEEP:
        if abs(shares[name] - keep) > ZOO3_KEEP_TOLERANCE:
            raise RuntimeError(f"zoo3: {name} kept {shares[name]:.4f} of its draws, expected {keep} +- "
                               f"{ZOO3_KEEP_TOLERANCE}")
    return shares


def zoo3_phase(data, card, profile_dir=None):
    """Phase 14 (b): EfficientNet-B0 at full width on the flagship round's
    data, at the clients its memory probe picks. The launch counts are set
    to 0 before the first checked round and read after the last: 2 rounds
    each of per leaf none (no launch), topk (3 K1), int8 (3 K2) and flat
    rotq (2 K3 over [clients, 2^22]), round 1's codec re-applied with the
    plain kernels, and each engine's first round's keep shares checked; the
    uncompressed engine then times 2 rounds and runs one more under the
    profiler (the device's idle share). Returns the results and the path's
    counts."""
    _free()
    model = "efficientnetb0"
    out = {"card": card}
    probe = _peak_probe(model, data, ZOO3_CLIENT_COUNTS[0], card)
    scaled = {n: probe["peak_gb"] * n / PROBE_CLIENTS for n in ZOO3_CLIENT_COUNTS}
    clients = next((n for n in ZOO3_CLIENT_COUNTS if scaled[n] < ZOO3_MAX_GB), ZOO3_CLIENT_COUNTS[-1])
    out["probe"] = {**probe, "scaled_gb": scaled, "clients": clients}
    log(f"zoo3: {model} probe {probe['peak_gb']:.2f} GB at {PROBE_CLIENTS} clients, scaled "
        f"{json.dumps({n: round(v, 2) for n, v in scaled.items()})}: {clients} clients")
    flops = model_flops(model, 10, clients * STEPS * BATCH)
    codecs = slice_codecs(EFFICIENTNET_LEAVES)
    peaks_gb, shares = {}, []
    kernels.reset_launch_counts()
    for codec, layout in ZOO_CASES:
        counted, per_round, make_plain = codecs[(codec, layout)]
        t0 = time.perf_counter()
        cfg = bench_cfg(codec, layout, model, clients=clients)
        rec = Recorder(compression.make_compressor(cfg.fed)) if make_plain else None
        fed = Federation(cfg, seed=0, data=data, compressor=rec.compressor() if rec else None)
        tag = f"zoo3 {model} {clients} clients {layout} {codec}"
        t_built = time.perf_counter()
        before = fed._generator.get_state()
        records = check_rounds(fed, tag, codec, layout, counted, per_round, rec, make_plain,
                               rounds=ZOO3_ROUNDS, peak=True)
        shares.append(_keep_shares(fed, before))
        out[tag] = {"clients": clients, "rounds": records, "keep_shares": shares[-1]}
        peaks_gb[tag] = max(r["peak_gb"] for r in records)
        t_checked = time.perf_counter()
        if codec == "none":
            out["timed"] = _zoo_timing(fed, flops, card, clients, f"zoo3 {model} {clients} clients")
            _, out["idle_share"] = profile_phase(fed, profile_dir, "zoo3_efficientnetb0_per_leaf_none",
                                                rounds=1, warm=False)
        del fed, rec
        _free()
        log(f"clock: {tag}: engine {t_built - t0:.1f} s, checked rounds {t_checked - t_built:.1f} s, "
            f"timing and profile {time.perf_counter() - t_checked:.1f} s")
    counts = _launch_counts()
    log(f"zoo3: peaks {json.dumps(peaks_gb)}; keep shares {json.dumps(shares)}; device idle share of an "
        f"EfficientNet-B0 round {out['idle_share']:.4f} | {card}")
    return out, counts


# --------------------------------------------------------------- main


# -------------------------------------------- 15. sim engine, disaster drill

SIM_POPULATION = 10_000
SIM_HALF_POPULATION = 5_000
SIM_SCENARIO = "dirichlet:alpha=0.1+quantity_skew:power=1.5"  # docs/SIMULATION.md:27
SIM_ROUNDS = 3  # step() rounds per codec, each a new cohort
SIM_BLOCK = 2  # rounds of the run_on_device block
SIM_CASES = (("topk", 2), ("int8", 1))  # codec, launches a round at MobileNet's 83 leaves
DISASTER_ROT_ROUND = 3  # the newest generation when the engine "crashes"
DISASTER_ROUNDS = 4  # the control's rounds; the resumed engine runs 3-4
GRPC_CLIENTS = 4
GRPC_CRASH_AFTER = 2  # the primary commits rounds 0-1, then stops (4 before phase 16)
GRPC_ROUNDS = 3  # the control's rounds, and the recovered lineage's end (5 before phase 16)
# The kernels each path of phases 15-17 runs (every other path runs all three).
PATH_KERNELS = {"sim": ("threshold_feedback", "quantdequant_int8"), "disaster": ("threshold_feedback",),
                "async": (), "solo": (), "obs": ("threshold_feedback",), "trace": ("threshold_feedback",)}


def _sim_cfg(codec, population=SIM_POPULATION) -> RoundConfig:
    """The deployment of ``docs/SIMULATION.md``: MobileNet at full width,
    ``population`` clients through NUM_CLIENTS seats, on the flagship
    round's traffic, the gather layout (the sim engine's)."""
    return bench_cfg(codec, "per_leaf", "mobilenet", data_kw=dict(device_layout="gather"),
                     fed_kw=dict(sim=SimConfig(population=population, scenario=SIM_SCENARIO)))


def _seat_bytes(fed) -> int:
    """Device bytes of the per-seat state: momentum, codec residuals and
    loss observations, each ``[cohort, ...]``."""
    ts = list(fed.state.opt_state.values()) + _tensors(fed.state.comp_state) + [fed.state.last_client_loss]
    if any(t.shape[0] != fed.cfg.fed.num_clients for t in ts):
        raise RuntimeError("sim: a per-seat tensor is not cohort-sized")
    return sum(t.numel() * t.element_size() for t in ts)


def _uniform_keys(fed, r) -> torch.Tensor:
    """Gather keys for round ``r`` from numpy, the same on both devices."""
    return torch.from_numpy(np.random.default_rng(7000 + r).random(fed.client_idx.shape, dtype=np.float32))


def sim_reference_phase():
    """A small sim round on the card against the same round on the CPU:
    smallcnn, a population of 256 through 4 seats, per-leaf top-k, 2
    rounds, each a new cohort (seats reset), the same numpy gather keys on
    both devices and no augmentation; params within the reference
    tolerance, the population tables equal."""
    from fedtpu_torch.sim import SimFederation

    rng = np.random.default_rng(15)
    data = (rng.standard_normal((512, 32, 32, 3), dtype=np.float32), rng.integers(0, 10, 512).astype(np.int32))
    cfg = dataclasses.replace(_small_cfg("topk"), data=DataConfig(
        dataset="cifar10", batch_size=8, partition="iid", augment=False, device_layout="gather"))
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, sim=SimConfig(population=256)))
    cpu = SimFederation(cfg, seed=0, data=data, device="cpu")
    gpu = SimFederation(cfg, seed=0, data=data)
    gpu.state = gpu.state._replace(params={k: v.cuda() for k, v in cpu.state.params.items()})
    reset = 0
    for r in range(2):
        for fed in (cpu, gpu):
            before = fed._slot_ids.copy()
            fed._install_cohort(r)
            reset += int((before != fed._slot_ids).sum()) if fed is gpu else 0
            Federation.step(fed, fed.device_batch(r, keys=_uniform_keys(fed, r)))
            fed._observe_back()
    if not reset:
        raise RuntimeError("sim reference: no seat was reassigned")
    if not np.array_equal(cpu.population.times_sampled, gpu.population.times_sampled):
        raise RuntimeError("sim reference: the two devices drew other cohorts")
    bad = total = 0
    worst = 0.0
    for k, w in cpu.state.params.items():
        g = gpu.state.params[k].cpu()
        bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
        total += w.numel()
        worst = max(worst, float((g - w).abs().max()))
    if bad > 0.001 * total or not np.allclose(cpu.population.last_seen_loss, gpu.population.last_seen_loss,
                                                rtol=1e-4, equal_nan=True):
        raise RuntimeError(f"sim reference: {bad} of {total} coordinates differ from the CPU")
    log(f"sim reference: card vs CPU after 2 sim rounds ({reset} seats reassigned), {bad} of {total} "
        f"coordinates beyond tolerance, largest difference {worst:.3g}")


def _check_reset(fed, fresh: np.ndarray, tag: str) -> int:
    """The reassigned seats' momentum and residuals are zero (their
    initial values) and the engine holds the population's losses."""
    m = torch.from_numpy(fresh).cuda()
    for t in list(fed.state.opt_state.values()) + _tensors(fed.state.comp_state):
        if bool(t[m].any()):
            raise RuntimeError(f"sim {tag}: a reset seat kept momentum or residual")
    want = torch.from_numpy(fed.population.last_seen_loss[fed._cohort_ids]).cuda()
    if not torch.equal(torch.nan_to_num(fed.state.last_client_loss, 7.0), torch.nan_to_num(want, 7.0)):
        raise RuntimeError(f"sim {tag}: the engine does not hold the population's losses")
    return int(fresh.sum())


def sim_phase(data, card):
    """MobileNet at full width through the sim engine: a population of
    SIM_POPULATION (``docs/SIMULATION.md``'s deployment) through
    NUM_CLIENTS seats. SIM_ROUNDS rounds each of per-leaf topk (2 K1) and
    int8 (1 K2) through step(), a new cohort each round, the reassigned
    seats' state checked reset before it trains, round 1's codec re-applied
    with the plain kernels; then one run_on_device(SIM_BLOCK) block (one
    cohort). The launch counts are set to 0 before each engine's rounds and
    checked every round. The per-seat bytes at SIM_POPULATION and at
    SIM_HALF_POPULATION must be equal."""
    from fedtpu_torch.sim import SimFederation

    codecs = slice_codecs(MOBILENET_LEAVES)
    counts = collections.Counter()
    out = {"card": card}
    for codec, per_round in SIM_CASES:
        counted, want, make_plain = codecs[(codec, "per_leaf")]
        if want != per_round:
            raise RuntimeError(f"sim: {codec} expects {want} launches a round, not {per_round}")
        cfg = _sim_cfg(codec)
        rec = Recorder(compression.make_compressor(cfg.fed))
        t0 = time.perf_counter()
        fed = SimFederation(cfg, seed=0, data=data, compressor=rec.compressor())
        build_s = time.perf_counter() - t0
        pop = fed.population
        log(f"sim {codec}: engine over a population of {pop.size} built in {build_s:.1f} s "
            f"(shard_len {pop.idx.shape[1]}, heterogeneity {fed.heterogeneity:.4f}, "
            f"live seats {int(fed.alive.sum())})")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for r in range(SIM_ROUNDS):
            before = fed._slot_ids.copy()
            fed._install_cohort(r)
            reset = _check_reset(fed, before != fed._slot_ids, codec)
            if r and not reset:
                raise RuntimeError(f"sim {codec} round {r}: no seat was reassigned")
            launched = _launch_counts()
            rec.armed = r == 1
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = fed.step()
            loss = float(m.loss)
            secs = time.perf_counter() - t1
            after = _launch_counts()
            for name in after:
                expect = per_round if name == counted else 0
                if after[name] - launched[name] != expect:
                    raise RuntimeError(f"sim {codec} round {r}: {name} launched "
                                       f"{after[name] - launched[name]} times, expected {expect}")
            live = int(fed.alive.sum())
            if not math.isfinite(loss) or not all(bool(torch.isfinite(t).all()) for t in _state_tensors(fed.state)):
                raise RuntimeError(f"sim {codec} round {r}: loss {loss} or a state tensor is not finite")
            if pop.times_sampled.sum() != NUM_CLIENTS * (r + 1) or live != NUM_CLIENTS:
                raise RuntimeError(f"sim {codec} round {r}: {pop.times_sampled.sum()} draws, {live} live seats")
            log(f"sim {codec} round {r}: loss {loss:.6f} seats reset {reset} "
                f"launches {({k: after[k] - launched[k] for k in after})} {secs:.3f} s")
            if r == 1:
                _check_recorded(rec, make_plain, "per_leaf", f"sim {codec}")
            if r == SIM_ROUNDS - 1:
                out[codec] = {"warm_round_s": secs, "rounds_per_s": 1 / secs,
                              "client_epochs_per_s": live / secs,
                              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "seat_state_bytes": _seat_bytes(fed),
                              "never_sampled": pop.never_sampled(), "build_s": build_s}
        if codec == "int8":
            launched = _launch_counts()
            drawn = pop.times_sampled.sum()
            t1 = time.perf_counter()
            block = fed.run_on_device(SIM_BLOCK)
            losses = block.loss.cpu().numpy()
            secs = time.perf_counter() - t1
            got = _launch_counts()[counted] - launched[counted]
            if got != per_round * SIM_BLOCK or pop.times_sampled.sum() != drawn + NUM_CLIENTS:
                raise RuntimeError(f"sim block: {got} launches, {pop.times_sampled.sum() - drawn} draws")
            if not np.isfinite(losses).all() or not np.isfinite(pop.last_seen_loss[fed._cohort_ids]).all():
                raise RuntimeError(f"sim block: losses {losses}")
            log(f"sim int8 block of {SIM_BLOCK}: losses {losses.tolist()} one cohort, {got} K2, {secs:.3f} s")
            out["block_s"] = secs
        counts.update(_launch_counts())
        del fed, rec
        _free()
    cfg = _sim_cfg("topk", SIM_HALF_POPULATION)
    half = SimFederation(cfg, seed=0, data=data)
    out["seat_state_bytes_half_population"] = _seat_bytes(half)
    del half
    _free()
    if out["seat_state_bytes_half_population"] != out["topk"]["seat_state_bytes"]:
        raise RuntimeError(f"sim: per-seat bytes differ with the population: {out}")
    log("sim: " + json.dumps(out))
    return dict(counts)


class _Deterministic:
    """Deterministic CUDA algorithms and cuDNN while a block runs (warn
    only), restoring the flags after; ``ops`` collects the ops torch warns
    have no deterministic form."""

    def __init__(self):
        self.ops = set()

    def __enter__(self):
        self._prev = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        self._warnings = warnings.catch_warnings(record=True)
        self._seen = self._warnings.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._warnings.__exit__(*exc)
        for w in self._seen:
            text = str(w.message)
            if "deterministic" in text:
                self.ops.add(text.split(" does not have")[0].strip())
        on, warn_only, det, bench = self._prev
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
        return False


class DisasterEngineDrill:
    """Engine resume with generation fallback, bench.py's headline round
    (smallcnn, NUM_CLIENTS clients, per-leaf topk with error feedback):
    a control of DISASTER_ROUNDS rounds; an engine that saves every round
    through ``BackgroundCheckpointer(Checkpointer(keep=3))``, a ckpt_rot
    armed for round DISASTER_ROT_ROUND, and "crashes" after that round; a
    new engine that restores the newest generation that verifies (2) and
    runs on to DISASTER_ROUNDS. Its final state must be the control's bit
    for bit (rounds under deterministic algorithms; an op torch names as
    having no deterministic form makes it a tolerance check, naming the
    op). The three steps run apart, so the writer's compression runs
    beside other phases (zlib releases the GIL)."""

    def __init__(self, data, card):
        import tempfile

        from fedtpu_torch.checkpoint import BackgroundCheckpointer, Checkpointer
        from fedtpu_torch.ft import parse_chaos_spec

        self.data, self.card = data, card
        self.cfg = bench_cfg("topk", "per_leaf")
        self.det = _Deterministic()
        self.counts = collections.Counter()
        self.dir = tempfile.mkdtemp(prefix="fedtpu_torch_ckpt_")
        self.chaos = parse_chaos_spec(f"ckpt_rot:p=1.0,rounds={DISASTER_ROT_ROUND},max=1")
        self.chaos.set_round(0)
        self.ckpt = BackgroundCheckpointer(Checkpointer(self.dir, keep=3, chaos=self.chaos))
        self.writes, self.snap_s, self.gen_s = {}, [], []
        inner, save = self.ckpt.inner, self.ckpt.inner.save

        def written(r, tree):  # on the writer's thread: each write's seconds and bytes
            out = save(r, tree)
            self.writes[r] = dict(inner.last_save or {}, failed=out is None)
            return out

        inner.save = written

    def _rounds(self, fed, n):
        kernels.reset_launch_counts()
        with self.det:
            for _ in range(n):
                m = fed.step()
                if not math.isfinite(float(m.loss)):
                    raise RuntimeError("disaster engine: a non-finite loss")
        got = _launch_counts()
        if got["threshold_feedback"] != n or got["quantdequant_int8"] or got["hadamard_rotate"]:
            raise RuntimeError(f"disaster engine: {got} launches in {n} rounds")
        self.counts.update(got)

    def _save(self, fed, r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = fed.generation
        t1 = time.perf_counter()
        self.ckpt.save(r, gen)
        self.gen_s.append(t1 - t0)
        self.snap_s.append(time.perf_counter() - t0)

    def start(self):
        control = Federation(self.cfg, seed=0, data=self.data)
        self._rounds(control, DISASTER_ROUNDS)
        s = control.state
        self.control = {f: {k: v.cpu() for k, v in getattr(s, f).items()}
                        for f in ("params", "opt_state", "comp_state")}
        del control, s
        self.engine = Federation(self.cfg, seed=0, data=self.data)
        for r in range(1, DISASTER_ROT_ROUND):
            self._rounds(self.engine, 1)
            self._save(self.engine, r)
        log(f"disaster engine: control ran {DISASTER_ROUNDS} rounds; generations "
            f"1-{DISASTER_ROT_ROUND - 1} submitted")

    def crash(self):
        """The last round and its (rotting) generation, then the crash."""
        self._rounds(self.engine, 1)
        # The writer consults the schedule when it takes a save up: drain
        # it before the round moves, so the rot lands on this generation.
        t0 = time.perf_counter()
        self.ckpt.flush()
        self.wait_s = time.perf_counter() - t0
        self.chaos.set_round(DISASTER_ROT_ROUND)
        self._save(self.engine, DISASTER_ROT_ROUND)
        del self.engine
        _free()
        log(f"disaster engine: generation {DISASTER_ROT_ROUND} submitted, the engine dropped")

    def finish(self):
        import shutil

        t0 = time.perf_counter()
        self.ckpt.flush()
        wait = time.perf_counter() - t0
        fed = Federation(self.cfg, seed=0, data=self.data)
        t0 = time.perf_counter()
        r, tree = self.ckpt.restore_latest(fed.generation)
        fed.generation = tree
        restore_s = time.perf_counter() - t0
        if r != DISASTER_ROT_ROUND - 1 or fed.state.round_idx != r:
            raise RuntimeError(f"disaster engine: restored generation {r}, expected {DISASTER_ROT_ROUND - 1}")
        self._rounds(fed, DISASTER_ROUNDS - r)
        bad = total = 0
        worst = 0.0
        for f, want in self.control.items():
            for k, w in want.items():
                g = getattr(fed.state, f)[k].cpu()
                total += w.numel()
                if self.det.ops:
                    bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
                    worst = max(worst, float((g - w).abs().max()))
                elif not _bits_equal(g, w):
                    raise RuntimeError(f"disaster engine: {f}/{k} differs from the control")
        if bad > 0.001 * total:
            raise RuntimeError(f"disaster engine: {bad} of {total} coordinates differ from the control")
        sizes = sorted(os.path.getsize(os.path.join(self.dir, f)) for f in os.listdir(self.dir)
                       if f.endswith(".fckpt"))
        out = {"restored": r, "bit_equal": not self.det.ops, "nondeterministic_ops": sorted(self.det.ops),
               "beyond_tolerance": bad, "largest_difference": worst,
               "state_bytes": sum(t.numel() * t.element_size() for t in _state_tensors(fed.state)),
               "generation_bytes": sizes, "writes": self.writes,
               "on_loop_snapshot_s": self.snap_s, "generation_to_host_s": self.gen_s,
               "flush_wait_s": [self.wait_s, wait], "restore_s": restore_s, "card": self.card}
        log("disaster engine: " + json.dumps(out))
        self.ckpt.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        del fed
        _free()
        return dict(self.counts)


def _serialized(t, lock) -> None:
    """One client's card work at a time (as phase 10's clients); the state
    saves that follow a round run side by side."""
    impl = t._train_round_impl

    def train(*args):
        with lock:
            return impl(*args)

    t._train_round_impl = train


def disaster_grpc_phase(data, card):
    """The coordinator's cold restart over localhost gRPC
    (``tests/test_disaster.py``'s drill): GRPC_CLIENTS port MobileNet
    clients (HOST_STEPS steps, flat int8, the stream pipeline, server
    momentum), each with a ``state_dir``. A control of GRPC_ROUNDS rounds;
    then a primary that saves every round, its newest generation rotted,
    and stops after GRPC_CRASH_AFTER rounds; a new primary restores (falls
    back a generation), re-runs the voided round through the clients'
    rollback and runs on. The lineage must be continuous, the roster and
    the server momentum restored, the final global within phase 10's
    tolerance of the control's; K1-K3 launch 0 times."""
    import shutil
    import tempfile

    from fedtpu_torch.checkpoint import Checkpointer
    from fedtpu_torch.ft import parse_chaos_spec
    from fedtpu_torch.transport.federation import PrimaryServer, serve_client

    kernels.reset_launch_counts()
    n = GRPC_CLIENTS * HOST_STEPS * BATCH
    data, eval_data = (data[0][:n], data[1][:n]), (data[0][:FED_EVAL], data[1][:FED_EVAL])
    cfg = _fed_cfg("flat", "int8", "stream")
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, server_optimizer="momentum", server_lr=1.0))
    root = tempfile.mkdtemp(prefix="fedtpu_torch_drill_")
    lock = threading.Lock()

    def fleet(tag):
        servers, agents = [], []
        for k in range(GRPC_CLIENTS):
            # The control's clients keep no state on disk: it never stops.
            state_dir = os.path.join(root, f"{tag}{k}") if tag else None
            server, agent = serve_client(f"localhost:{_free_port()}", cfg, seed=k, data=data, eval_data=eval_data,
                                         state_dir=state_dir)
            _serialized(agent.trainer, lock)
            servers.append(server)
            agents.append(agent)
        return servers, agents

    def stop(servers):
        for s in servers:
            s.stop(0)

    try:
        servers, agents = fleet(None)
        primary = PrimaryServer(cfg, [a.trainer.identity for a in agents])
        t0 = time.perf_counter()
        lineage = [primary.round()["round"] for _ in range(GRPC_ROUNDS)]
        control_s = time.perf_counter() - t0
        want = _leaves_row(primary._host_model())
        del primary
        stop(servers)
        servers, agents = fleet("client")
        addrs = [a.trainer.identity for a in agents]
        chaos = parse_chaos_spec(f"ckpt_rot:p=1.0,rounds={GRPC_CRASH_AFTER - 1},max=1")
        ckpt = Checkpointer(os.path.join(root, "primary"), keep=3, chaos=chaos)
        primary = PrimaryServer(cfg, addrs, chaos=chaos)
        first, save_s, round_s = [], [], []
        for r in range(GRPC_CRASH_AFTER):
            t0 = time.perf_counter()
            rec = primary.round()
            t1 = time.perf_counter()
            ckpt.save(r, primary.state_tree())
            save_s.append(time.perf_counter() - t1)
            round_s.append((t1 - t0, rec["t_collect_s"]))
            first.append(rec["round"])
        roster, version = sorted(primary.registry.clients), primary.registry.version
        t_stop = time.perf_counter()
        del primary  # the crash: the disk is the only copy
        primary = PrimaryServer(cfg, addrs)
        start = primary.restore_from_checkpoint(Checkpointer(os.path.join(root, "primary"), keep=3))
        t_restored = time.perf_counter()
        gen = Checkpointer(os.path.join(root, "primary"), keep=3).restore(start - 1, primary.state_template())
        trace = _leaves_row(gen["server_opt"]["0"]["trace"])
        got_trace = _leaves_row(primary.state_tree()["server_opt"]["0"]["trace"])
        if start != GRPC_CRASH_AFTER - 1 or sorted(primary.registry.clients) != roster \
                or primary.registry.version != version or trace.tobytes() != got_trace.tobytes():
            raise RuntimeError(f"disaster grpc: restored round {start}, roster or moments not restored")
        second = []
        for i in range(GRPC_ROUNDS - start):
            t0 = time.perf_counter()
            rec = primary.round()
            round_s.append((time.perf_counter() - t0, rec["t_collect_s"]))
            if i == 0:
                recover_s = time.perf_counter() - t_stop
            if rec["participants"] != GRPC_CLIENTS or rec.get("aborted"):
                raise RuntimeError(f"disaster grpc: a recovered round lost clients: {rec}")
            second.append(rec["round"])
        if lineage != list(range(GRPC_ROUNDS)) or [r for r in first if r < start] + second != lineage:
            raise RuntimeError(f"disaster grpc: lineage {first} + {second}, control {lineage}")
        got = _leaves_row(primary._host_model())
        bad = _beyond(got, want)
        if not np.isfinite(got).all() or bad > 0.001 * want.size:
            raise RuntimeError(f"disaster grpc: {bad} of {want.size} coordinates differ from the control")
        client_gen = sorted(os.path.getsize(os.path.join(root, "client0", f))
                            for f in os.listdir(os.path.join(root, "client0")) if f.endswith(".fckpt"))
        out = {"restored_from": start - 1, "lineage": [r for r in first if r < start] + second,
               "beyond_tolerance": bad, "largest_difference": float(np.abs(got - want).max()),
               "time_to_recover_s": recover_s, "restore_s": t_restored - t_stop,
               "control_round_s": control_s / GRPC_ROUNDS, "drill_round_and_collect_s": round_s,
               "client_save_s": [a.trainer._state_ckpt.last_save["wall_s"] for a in agents],
               "primary_save_s": save_s,
               "primary_generation_bytes": ckpt.last_save["bytes"], "client_generation_bytes": client_gen,
               "card": card}
        log("disaster grpc: " + json.dumps(out))
        del primary
    finally:
        stop(servers)
        shutil.rmtree(root, ignore_errors=True)
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"disaster grpc: K1-K3 launched on the coordinator's path: {counts}")
    return counts


# ----------------------------------------------- 16. the async engine and solo

ASYNC_BUFFER = 2  # FedBuff's buffer_k: the JAX package's CLI default (fedtpu/cli/run.py:79)
ASYNC_POWER = 0.5  # staleness_power: the CLI default (fedtpu/cli/run.py:80)
ASYNC_SIGMA = 1.0  # heterogeneous speeds (tools/async_convergence_study.py:67-72)
ASYNC_BLOCK = 10  # ticks of the JAX package's async_fused10 program
ASYNC_MOBILENET_TICKS = 2  # tick() calls, then one run_on_device block of as many
ASYNC_GRPC_UPDATES = 8
ASYNC_SLOW_S = 3.0  # the slowed client's sleep before each StartTrain after its first
SOLO_EXAMPLES = 384 * BATCH  # one epoch of 384 steps, 49,152 examples


def _fedbuff(cfg, data, device=None, **kw):
    from fedtpu_torch.core.async_engine import AsyncFederation

    kw = {"buffer_k": ASYNC_BUFFER, "staleness_power": ASYNC_POWER, "speed_sigma": ASYNC_SIGMA, **kw}
    return AsyncFederation(cfg, seed=0, data=data, device=device, **kw)


def _async_tensors(state):
    """Every tensor of an async state, by field and leaf."""
    for field in ("params", "batch_stats", "client_params", "client_stats", "base_params", "base_stats",
                  "opt_state"):
        for k, t in getattr(state, field).items():
            yield f"{field}.{k}", t
    for field in ("base_version", "pending", "last_client_loss"):
        yield field, getattr(state, field)


def _async_beyond(got, want):
    """Coordinates of two async states beyond the reference tolerance (in
    the float fields), their count and the largest difference; the
    counters and flags must be equal."""
    if got.version != want.version:
        raise RuntimeError(f"async: versions {got.version} and {want.version}")
    bad = total = 0
    worst = 0.0
    for (name, g), (_, w) in zip(_async_tensors(got), _async_tensors(want)):
        g, w = g.detach().cpu(), w.detach().cpu()
        if not g.is_floating_point():
            if not torch.equal(g, w):
                raise RuntimeError(f"async: {name} differs: {g.tolist()} against {w.tolist()}")
            continue
        g, w = torch.nan_to_num(g.float(), 7.0), torch.nan_to_num(w.float(), 7.0)
        bad += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
        total += w.numel()
        worst = max(worst, float((g - w).abs().max()) if w.numel() else 0.0)
    return bad, total, worst


def _async_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for _, t in _async_tensors(state))


def async_reference_phase():
    """Small checks of the async engine and the solo trainer on the card
    against the CPU: smallcnn, 4 clients, batch 8, 2 steps, buffer 2,
    speed_sigma 0.7, no augmentation, the same numpy arrival draws and
    presharded offsets on both devices. 3 ticks on the card against the
    same ticks on the CPU; 3 tick() calls against one run_on_device(3)
    from the same state, under deterministic algorithms (to the bit, or
    within the tolerance with the ops torch names); a buffer_k ==
    num_clients tick against the synchronous round; 4 solo steps against
    the CPU's on the same noise. Tolerance: atol=1e-5, rtol=1e-4 on all but 0.1% of the
    coordinates (the reference phases' rule)."""
    from fedtpu_torch.core.solo import SoloTrainer

    rng = np.random.default_rng(16)
    data = (rng.standard_normal((256, 32, 32, 3), dtype=np.float32), rng.integers(0, 10, 256).astype(np.int32))
    cfg = _small_cfg("none")
    kernels.reset_launch_counts()
    small = dict(speed_sigma=0.7)
    cpu, gpu = _fedbuff(cfg, data, "cpu", **small), _fedbuff(cfg, data, **small)
    for _ in range(3):
        cpu.tick()
        gpu.tick()
    bad, total, worst = _async_beyond(gpu.state, cpu.state)
    if bad > 0.001 * total:
        raise RuntimeError(f"async reference: {bad} of {total} coordinates differ from the CPU")
    log(f"async reference: card vs CPU after 3 ticks, {bad} of {total} coordinates beyond tolerance, "
        f"largest difference {worst:.3g}")
    with _Deterministic() as det:
        seq, fused = _fedbuff(cfg, data, **small), _fedbuff(cfg, data, **small)
        for _ in range(3):
            seq.tick()
        fused.run_on_device(3)
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_async_tensors(seq.state), _async_tensors(fused.state)))
    fb, ft, fw = _async_beyond(fused.state, seq.state)
    if not same and (not det.ops or fb > 0.001 * ft):
        raise RuntimeError(f"async reference: run_on_device(3) is not 3 ticks: {fb} of {ft} beyond, "
                           f"largest {fw:.3g}, nondeterministic ops {sorted(det.ops)}")
    log(f"async reference: run_on_device(3) against 3 tick() calls: "
        + ("bit-equal" if same else f"{fb} of {ft} beyond tolerance (largest {fw:.3g}); ops without a "
                                    f"deterministic form: {sorted(det.ops)}"))
    sync = Federation(cfg, seed=0, data=data)
    full = _fedbuff(cfg, data, buffer_k=cfg.fed.num_clients, speed_sigma=0.0)
    sync.step()
    full.tick()
    sb = st = 0
    for k, w in sync.state.params.items():
        g = full.state.params[k]
        sb += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
        st += w.numel()
    if sb > 0.001 * st:
        raise RuntimeError(f"async reference: a full buffer's tick is not the synchronous round ({sb} of {st})")
    log(f"async reference: buffer_k == {cfg.fed.num_clients} tick against the synchronous round, {sb} of {st} "
        "coordinates beyond tolerance")
    scfg = RoundConfig(model="smallcnn", data=DataConfig(dataset="synthetic", batch_size=8, eval_batch_size=8,
                                                         num_examples=32),
                       fed=FedConfig(num_clients=1))
    order = np.random.default_rng(17).permutation(32)
    solo_cpu, solo_gpu = SoloTrainer(scfg, device="cpu"), SoloTrainer(scfg)
    for t in (solo_cpu, solo_gpu):
        # The phase's noise with random labels: the synthetic task's
        # separable classes saturate smallcnn's logits within 4 steps, and
        # f32 log-softmax bits then grow past any tolerance (phase 14).
        t.images, t.labels = data[0][:32], data[1][:32]
    losses = [t.train_epoch(order=order)[0] for t in (solo_cpu, solo_gpu)]
    sb = st = 0
    for k, w in solo_cpu.params.items():
        g = solo_gpu.params[k].cpu()
        sb += int(((g - w).abs() > 1e-5 + 1e-4 * w.abs()).sum())
        st += w.numel()
    if sb > 0.001 * st or not math.isclose(losses[0], losses[1], rel_tol=1e-4):
        raise RuntimeError(f"solo reference: 4 steps differ from the CPU ({sb} of {st}; losses {losses})")
    log(f"solo reference: 4 steps on the card against the CPU, {sb} of {st} coordinates beyond tolerance, "
        f"losses {losses}")
    if any(_launch_counts().values()):
        raise RuntimeError(f"async reference: K1-K3 launched: {_launch_counts()}")


def _ticks_record(m, secs, ticks):
    """A block's numbers: per tick the clients that trained (the nonzero
    per-client losses), the arrivals and the arrivals' mean staleness."""
    trained = (m.per_client_loss != 0).sum(-1).reshape(-1).tolist()
    arrived = m.num_arrived.reshape(-1).tolist()
    return {"ticks": ticks, "s": secs, "ticks_per_s": ticks / secs, "trained_per_tick": trained,
            "arrived_per_tick": arrived, "staleness_mean": m.staleness_mean.reshape(-1).tolist(),
            "loss": m.loss.reshape(-1).tolist()}


def _check_async(fed, rec, version, tag):
    s = fed.state
    if s.version != version or any(a != ASYNC_BUFFER for a in rec["arrived_per_tick"]):
        raise RuntimeError(f"async {tag}: version {s.version}, arrivals {rec['arrived_per_tick']}")
    if bool((s.pending & (s.base_version == s.version)).any()):
        raise RuntimeError(f"async {tag}: a client just arrived and is pending")
    for name, t in _async_tensors(s):
        if t.is_floating_point() and name != "last_client_loss" and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"async {tag}: {name} is not finite")


def async_phase(data, card):
    """(a) the JAX package's async_fused10 chip program
    (tools/compile_pallas_tpu.py): smallcnn at bench.py's traffic, FedBuff
    at buffer 2, power 0.5, damping, speed_sigma 1.0; one
    run_on_device(ASYNC_BLOCK) cold, one warm and timed. (b) MobileNet at
    full width on the flagship traffic, the same FedBuff settings:
    ASYNC_MOBILENET_TICKS tick() calls, then one run_on_device of as many;
    the warm tick timed, the async state's bytes. Arrivals, versions, the
    pending flags and finite state checked; no K1-K3 launch."""
    out = {"card": card}
    kernels.reset_launch_counts()
    fed = _fedbuff(bench_cfg("none"), data)
    torch.cuda.reset_peak_memory_stats()
    for i, tag in enumerate(("cold", "warm")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fed.run_on_device(ASYNC_BLOCK)
        torch.cuda.synchronize()
        rec = _ticks_record(m, time.perf_counter() - t0, ASYNC_BLOCK)
        _check_async(fed, rec, ASYNC_BLOCK * (i + 1), f"smallcnn {tag}")
        log(f"async smallcnn fused{ASYNC_BLOCK} {tag}: " + json.dumps(rec))
    out["smallcnn"] = {**rec, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "state_bytes": _async_bytes(fed.state)}
    del fed
    _free()
    fed = _fedbuff(bench_cfg("none", "per_leaf", "mobilenet"), data)
    torch.cuda.reset_peak_memory_stats()
    tick_s = []
    for _ in range(ASYNC_MOBILENET_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fed.tick()
        loss = float(m.loss)
        tick_s.append(time.perf_counter() - t0)
        if float(m.num_arrived) != ASYNC_BUFFER or not math.isfinite(loss):
            raise RuntimeError(f"async mobilenet: tick arrivals {float(m.num_arrived)}, loss {loss}")
    t0 = time.perf_counter()
    m = fed.run_on_device(ASYNC_MOBILENET_TICKS)
    torch.cuda.synchronize()
    rec = _ticks_record(m, time.perf_counter() - t0, ASYNC_MOBILENET_TICKS)
    _check_async(fed, rec, 2 * ASYNC_MOBILENET_TICKS, "mobilenet")
    params = sum(t.numel() for t in fed.state.params.values())
    stats = sum(t.numel() for t in fed.state.batch_stats.values())
    out["mobilenet"] = {"tick_s": tick_s, "warm_tick_s": tick_s[-1], "block": rec,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "state_bytes": _async_bytes(fed.state),
                        "three_param_stacks_bytes": 3 * NUM_CLIENTS * params * 4,
                        "two_stat_stacks_bytes": 2 * NUM_CLIENTS * stats * 4, "params": params}
    log("async mobilenet: " + json.dumps(out["mobilenet"]))
    del fed
    _free()
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"async: K1-K3 launched on the async engine's path: {counts}")
    log("async: " + json.dumps({k: {kk: v[kk] for kk in ("ticks_per_s", "peak_gb", "state_bytes") if kk in v}
                               if isinstance(v, dict) else v for k, v in out.items()}))
    return counts


def async_grpc_phase(data, card):
    """PrimaryServer.run_async over localhost gRPC: a port primary and
    FED_CLIENTS port MobileNet clients (HOST_STEPS steps of batch BATCH,
    bf16, the cut of phases 9-11), the last one sleeping ASYNC_SLOW_S before
    each StartTrain after its first; buffer 2, power 0.5, damping;
    ASYNC_GRPC_UPDATES updates. Each update's new global within phase 10's
    tolerance of the CPU's FedBuff apply of the same buffer; the fast
    clients carry more updates than the slow one; the final sync leaves
    every client on the primary's model; no K1-K3 launch."""
    from fedtpu_torch.transport.federation import PrimaryServer, serve_client

    kernels.reset_launch_counts()
    n = FED_CLIENTS * HOST_STEPS * BATCH
    data, eval_data = (data[0][:n], data[1][:n]), (data[0][:FED_EVAL], data[1][:FED_EVAL])
    cfg = _fed_cfg("per_leaf", "none", "barrier")
    lock = threading.Lock()
    servers, agents = [], []
    applied = []
    apply = edge_aggregation.fedbuff_apply

    def spy(cfg_, global_tree, stacked, raw, stal, power, damping, opt_state, round_idx, server=None):
        new, new_opt = apply(cfg_, global_tree, stacked, raw, stal, power, damping, opt_state, round_idx,
                             server=server)
        cpu = lambda tree: {c: {k: v.detach().cpu() for k, v in t.items()} for c, t in tree.items()}  # noqa: E731
        applied.append((cpu(global_tree), cpu(stacked), list(raw), list(stal), round_idx, cpu(new)))
        return new, new_opt

    try:
        for k in range(FED_CLIENTS):
            server, agent = serve_client(f"localhost:{_free_port()}", cfg, seed=k, data=data, eval_data=eval_data)
            _serialized(agent.trainer, lock)
            servers.append(server)
            agents.append(agent)
        slow = agents[-1].trainer
        calls = [0]
        train = slow.train_round

        def slowed(*args, **kwargs):
            calls[0] += 1
            if calls[0] > 1:
                time.sleep(ASYNC_SLOW_S)
            return train(*args, **kwargs)

        slow.train_round = slowed
        addrs = [a.trainer.identity for a in agents]
        primary = PrimaryServer(cfg, addrs)
        edge_aggregation.fedbuff_apply = spy
        t0 = time.perf_counter()
        try:
            history = primary.run_async(ASYNC_GRPC_UPDATES, buffer_k=ASYNC_BUFFER, staleness_power=ASYNC_POWER)
        finally:
            edge_aggregation.fedbuff_apply = apply
        wall = time.perf_counter() - t0
        if len(history) != ASYNC_GRPC_UPDATES or len(applied) != ASYNC_GRPC_UPDATES:
            raise RuntimeError(f"async grpc: {len(history)} updates recorded, {len(applied)} applied")
        lay = primary.layout
        worst_bad = 0
        for rec, (g, stacked, raw, stal, r, got) in zip(history, applied):
            if rec["staleness"] != stal or r != rec["update"] - 1:
                raise RuntimeError(f"async grpc: update {rec} applied {stal} at {r}")
            want, _ = apply(cfg, g, stacked, raw, stal, ASYNC_POWER, True, (), r)
            bad = _beyond(flat.pack_tree(lay, got).numpy(), flat.pack_tree(lay, want).numpy())
            worst_bad = max(worst_bad, bad)
            if bad > 0.001 * lay.total:
                raise RuntimeError(f"async grpc: update {rec['update']}: {bad} coordinates differ from the CPU")
        by_client = collections.Counter(c for rec in history for c in rec["contributors"])
        fast = [by_client[a] for a in addrs[:-1]]
        if not by_client[addrs[-1]] < sum(fast) / len(fast):
            raise RuntimeError(f"async grpc: the slow client carried {by_client[addrs[-1]]}, the fast {fast}")
        got = _leaves_row(primary._host_model())
        for a in agents:
            if _leaves_row(a.trainer.host_model()).tobytes() != got.tobytes():
                raise RuntimeError(f"async grpc: client {a.trainer.identity} missed the final sync")
        out = {"updates": len(history), "wall_s": wall, "updates_per_s": len(history) / wall,
               "contributors": [[addrs.index(c) for c in rec["contributors"]] for rec in history],
               "staleness": [rec["staleness"] for rec in history],
               "updates_by_client": [by_client[a] for a in addrs], "cpu_beyond_max": worst_bad, "card": card}
        log("async grpc: " + json.dumps(out))
        del primary
    finally:
        for s_ in servers:
            s_.stop(0)
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"async grpc: K1-K3 launched on run_async's path: {counts}")
    return counts


def solo_phase(data, card):
    """SoloTrainer at MobileNet's full width, the reference's own trainer
    (src/main.py per SURVEY.md: batch 128, eval batch 100, lr 0.1, momentum
    0.9, weight decay 5e-4, augmentation): one epoch over SOLO_EXAMPLES
    synthetic CIFAR-10 examples (384 steps, the phase's ``data``) and a
    test epoch that writes the checkpoint; a fresh trainer resumes from it,
    its weights, momentum, statistics, epoch and best accuracy bit-equal;
    no K1-K3 launch."""
    import shutil
    import tempfile

    from fedtpu_torch.core.solo import SoloTrainer

    kernels.reset_launch_counts()
    cfg = RoundConfig(
        model="mobilenet", num_classes=10,
        opt=OptimizerConfig(learning_rate=0.1, momentum=0.9, weight_decay=5e-4),
        data=DataConfig(dataset="cifar10", batch_size=BATCH, eval_batch_size=100, num_examples=SOLO_EXAMPLES),
        fed=FedConfig(num_clients=1),
    )
    root = tempfile.mkdtemp(prefix="fedtpu_torch_solo_")
    path = os.path.join(root, "solo.fckpt")
    data = (data[0][:SOLO_EXAMPLES], data[1][:SOLO_EXAMPLES])
    test_data = datasets.load("cifar10", "test", seed=0)
    try:
        t = SoloTrainer(cfg, checkpoint_path=path, data=data, test_data=test_data)
        t._device_data()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = t.train_epoch()
        epoch_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        test_loss, test_acc = t.test_epoch()
        test_s = time.perf_counter() - t1
        steps = SOLO_EXAMPLES // BATCH
        if not (math.isfinite(loss) and math.isfinite(test_loss)) or not os.path.exists(path):
            raise RuntimeError(f"solo: loss {loss}, test loss {test_loss}, checkpoint {os.path.exists(path)}")
        r = SoloTrainer(cfg, checkpoint_path=path, resume=True, data=data, test_data=test_data)
        for tree in ("params", "batch_stats", "opt_state"):
            a, b = getattr(t, tree), getattr(r, tree)
            if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
                raise RuntimeError(f"solo: the resumed {tree} differ")
        if (r.epoch, r.best_acc) != (t.epoch, t.best_acc):
            raise RuntimeError(f"solo: resumed epoch {r.epoch} best {r.best_acc}, saved {t.epoch} {t.best_acc}")
        out = {"steps": steps, "epoch_s": epoch_s, "steps_per_s": steps / epoch_s,
               "examples_per_s": SOLO_EXAMPLES / epoch_s, "test_epoch_s": test_s, "loss": loss, "acc": acc,
               "test_acc": test_acc, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "checkpoint_bytes": os.path.getsize(path), "card": card}
        log("solo: " + json.dumps(out))
        del t, r
        _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = _launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"solo: K1-K3 launched on the solo path: {counts}")
    return counts


# -------------------------------------------------------------- 17. obs

OBS_ROUNDS = 2  # rounds under each telemetry mode
OBS_POLL_S = 0.05  # the scraper's pause between passes over the four routes
OBS_ROUTES = ("/metrics", "/statusz", "/healthz", "/flightz")


def _metric(registry, name: str, **labels) -> float:
    """A counter's or gauge's value in ``registry`` (0 when it never
    counted), read from a snapshot so that reading creates nothing."""
    for entry in registry.snapshot().get(name, []):
        if entry["labels"] == labels:
            return entry["value"]
    return 0.0


class _Scraper:
    """A thread that polls an ObsServer's four routes every OBS_POLL_S
    seconds, parsing each answer, until stopped; ``/metrics`` latencies in
    ms, and every failure, kept."""

    def __init__(self, url: str):
        self.url = url
        self.metrics_ms = []
        self.passes = 0
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def get(self, route: str):
        import urllib.request

        from fedtpu_torch.obs import parse_prometheus_text

        t0 = time.perf_counter()
        with urllib.request.urlopen(self.url + route, timeout=10) as resp:
            status, body = resp.status, resp.read().decode()
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise RuntimeError(f"{route}: HTTP {status}")
        if route == "/metrics":
            return parse_prometheus_text(body), ms
        if route == "/healthz":
            if body != "ok\n":
                raise RuntimeError(f"/healthz: {body!r}")
            return body, ms
        return json.loads(body), ms

    def _run(self) -> None:
        while not self._stop.is_set():
            for route in OBS_ROUTES:
                try:
                    _, ms = self.get(route)
                except Exception as exc:  # kept, and raised by the phase
                    self.errors.append(f"{route}: {exc!r}")
                    continue
                if route == "/metrics":
                    self.metrics_ms.append(ms)
            self.passes += 1
            self._stop.wait(OBS_POLL_S)

    def __enter__(self) -> "_Scraper":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def _timed_rounds(fed, rounds: int, flight) -> float:
    """``rounds`` Federation.step rounds, each recorded in ``flight``;
    rounds/s by the host clock around a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        m = fed.step()
        flight.record("round", round=fed.state.round_idx - 1, loss=float(m.loss))
    torch.cuda.synchronize()
    return rounds / (time.perf_counter() - t0)


def obs_phase(fed, card):
    """Phase 17: the observability plane on a live MobileNet engine (phase
    6's per-leaf topk Federation, or one built like it). An ObsServer on
    127.0.0.1 serves the engine's registry, its status snapshot and a
    flight recorder while a thread scrapes the four routes every
    OBS_POLL_S; OBS_ROUNDS rounds under ``telemetry='basic'`` (K1's
    launches counted from 0, 2 a round), then as many with
    ``Telemetry("off")`` swapped in. Every scrape must answer 200 and
    parse; the rounds counter must equal the rounds the engine stepped
    since it was built and /statusz end at that round, idle, every client
    alive. Rounds/s under each mode and the /metrics scrape latency are
    logged; no speed is asserted. Returns the path's launch counts and
    the rounds/s under each mode."""
    import shutil
    import tempfile

    from fedtpu_torch.obs import FlightRecorder, ObsServer, Telemetry

    n = fed.cfg.fed.num_clients
    root = tempfile.mkdtemp(prefix="fedtpu_torch_obs_")
    flight = FlightRecorder(role="engine", artifacts_dir=root)
    server = ObsServer(port=0, registry=fed.telemetry.registry, status_fn=fed.status_snapshot,
                       flight=flight).start()
    try:
        with _Scraper(server.url) as scraper:
            kernels.reset_launch_counts()
            basic = _timed_rounds(fed, OBS_ROUNDS, flight)
            counts = _launch_counts()
            stepped = fed.state.round_idx
            done = _metric(fed.telemetry.registry, "fedtpu_rounds_completed_total")
            status, _ = scraper.get("/statusz")
            metrics, _ = scraper.get("/metrics")
            fed.telemetry = Telemetry("off")
            off = _timed_rounds(fed, OBS_ROUNDS, flight)
        ring, _ = scraper.get("/flightz")
        final, _ = scraper.get("/statusz")
    finally:
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    if scraper.errors or not scraper.metrics_ms:
        raise RuntimeError(f"obs: {len(scraper.errors)} failed scrapes of {scraper.passes} passes: "
                           f"{scraper.errors[:3]}")
    if done != stepped or metrics["fedtpu_rounds_completed_total"][""] != stepped:
        raise RuntimeError(f"obs: {done} rounds counted, {stepped} stepped since the engine was built")
    if (status["round"], status["phase"], status["alive"]) != (stepped, "idle", [True] * n):
        raise RuntimeError(f"obs: /statusz {status['round']} {status['phase']} after {stepped} rounds")
    if final["round"] != stepped + OBS_ROUNDS or final["role"] != "engine":
        raise RuntimeError(f"obs: /statusz at {final['round']} after the off rounds")
    if counts["threshold_feedback"] != 2 * OBS_ROUNDS or sum(counts.values()) != 2 * OBS_ROUNDS:
        raise RuntimeError(f"obs: launches {counts}, expected K1 twice a round")
    if [e["round"] for e in ring] != list(range(stepped - OBS_ROUNDS, stepped + OBS_ROUNDS)):
        raise RuntimeError(f"obs: the flight ring holds {[e['round'] for e in ring]}")
    lat = sorted(scraper.metrics_ms)
    log("obs: " + json.dumps({
        "rounds_per_s_basic": basic, "rounds_per_s_off": off, "basic_over_off": basic / off,
        "scrape_passes": scraper.passes, "metrics_scrapes": len(lat),
        "metrics_scrape_p50_ms": lat[len(lat) // 2], "metrics_scrape_max_ms": lat[-1],
        "metric_names": len(metrics), "launches": counts, "card": card}))
    return counts, {"basic": basic, "off": off}


# -------------------------------------------------------------- 18. trace

TRACE_ROUNDS = 2  # profiled rounds, fused rounds, and timed rounds under trace
# The host calls that launch a kernel: the CUDA runtime's cudaLaunch* and the
# lower-level API's cuLaunch*.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")


def _round_launches(prof, kernel: str):
    """From a stopped profiler's events, read as they are: the host's
    ``round`` ranges (the tracer's record_function bridge), ``kernel``'s
    executions on the device, and for each the start of the host call that
    launched it, matched by the runtime's correlation id."""
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((start, start + dur) for start, dur in
                    (_span_us(e) for e in events if e.device_type() == cpu and e.name() == "round"))
    device = [e for e in events if _on_device(e) and kernel in e.name()]
    corr = {e.correlation_id() for e in device}
    calls = [e for e in events if e.device_type() == cpu and e.name().startswith(LAUNCH_CALLS)]
    launches = sorted(_span_us(e)[0] for e in calls if e.correlation_id() in corr)
    if len(launches) != len(device):
        raise RuntimeError(
            f"trace: {len(device)} {kernel} kernels on the device but {len(launches)} host launches "
            f"matched by correlation id, of {len(calls)} launch calls "
            f"({sorted({e.name() for e in calls})[:6]})")
    return ranges, device, launches


def trace_phase(fed, card, basic_rate: Optional[float] = None):
    """Phase 18: the span tracer on a live MobileNet engine (phase 6's
    per-leaf topk Federation after phase 17, or one built like it).
    ``Telemetry("trace", role="engine")`` is swapped in, its spans fed to a
    flight recorder. TRACE_ROUNDS rounds through ``step()`` inside
    ``torch.profiler.profile`` (host and device), K1's launches counted
    from 0: one ``round`` span a round with the engine's round numbers, K1
    twice a round and K2/K3 never, one ``record_function`` range named
    ``round`` a round among the profiler's events, each host launch of
    K1's kernel inside one of them (two in each), and the kernel's device
    executions counted. The flight ring holds the spans; ``export_trace``
    writes them to a temporary directory, whose path is logged, and they
    load back with their metadata; ``/statusz``'s ``trace_id`` is the
    tracer's. One ``run_on_device`` block is one ``fused_rounds`` span.
    Rounds/s under trace, outside the profiler, are logged beside phase
    17's ``basic`` figure; no speed is asserted. Returns the path's launch
    counts."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from fedtpu_torch.obs import FlightRecorder, Telemetry, load_chrome_trace

    root = tempfile.mkdtemp(prefix="fedtpu_torch_trace_")
    try:
        tel = Telemetry("trace", role="engine")
        flight = FlightRecorder(role="engine", artifacts_dir=root)
        tel.tracer.sink = flight.record_span
        fed.telemetry = tel
        r0 = fed.state.round_idx
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_ROUNDS):
                fed.step()
            torch.cuda.synchronize()
        counts = _launch_counts()
        profiled_s = time.perf_counter() - t0
        t_read = time.perf_counter()
        ranges, device, launches = _round_launches(prof, "threshold_feedback")
        read_s = time.perf_counter() - t_read
        spans = tel.trace_events()
        per_range = [sum(lo <= t <= hi for t in launches) for lo, hi in ranges]
        if [(e["name"], e["args"]["round"], e["args"].get("parent_id")) for e in spans] != [
                ("round", r0 + i, None) for i in range(TRACE_ROUNDS)]:
            raise RuntimeError(f"trace: spans {[(e['name'], e['args']) for e in spans]} after rounds {r0}..")
        if counts["threshold_feedback"] != 2 * TRACE_ROUNDS or sum(counts.values()) != 2 * TRACE_ROUNDS:
            raise RuntimeError(f"trace: launches {counts}, expected K1 twice a round")
        if len(ranges) != TRACE_ROUNDS:
            raise RuntimeError(f"trace: {len(ranges)} record_function ranges named round in the profile, "
                               f"expected {TRACE_ROUNDS}: the profiler bridge did not open them")
        if per_range != [2] * TRACE_ROUNDS or len(device) != 2 * TRACE_ROUNDS:
            raise RuntimeError(f"trace: K1's {len(launches)} host launches fall {per_range} in the round "
                               f"ranges, {len(device)} device executions")
        ring = [e for e in flight.snapshot() if e["kind"] == "span"]
        if [(e["name"], e["args"]["round"]) for e in ring] != [("round", r0 + i) for i in range(TRACE_ROUNDS)]:
            raise RuntimeError(f"trace: the flight ring holds {ring}")
        path = os.path.join(root, "trace_engine.json")
        tel.export_trace(path)
        exported = os.path.getsize(path)
        meta = json.loads(Path(path).read_text())["metadata"]
        if load_chrome_trace(path) != spans or meta["trace_id"] != tel.tracer.trace_id or meta["role"] != "engine":
            raise RuntimeError(f"trace: the export at {path} does not load back ({meta})")
        if fed.status_snapshot().get("trace_id") != tel.tracer.trace_id:
            raise RuntimeError("trace: /statusz does not name the tracer's trace_id")
        tel.tracer.clear()
        fed.run_on_device(TRACE_ROUNDS)
        torch.cuda.synchronize()
        fused = [(e["name"], e["args"]["round"], e["args"]["num_rounds"]) for e in tel.trace_events()
                 if e["name"] == "fused_rounds"]
        if len(tel.trace_events()) != 1 or fused != [("fused_rounds", r0 + TRACE_ROUNDS, TRACE_ROUNDS)]:
            raise RuntimeError(f"trace: one run_on_device block gave {tel.trace_events()}, "
                               "expected one fused_rounds span")
        tel.tracer.clear()
        rate = _timed_rounds(fed, TRACE_ROUNDS, flight)
        log(f"trace: export {path} ({exported} bytes), removed at the phase's end")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("trace: " + json.dumps({
        "rounds_per_s_trace": rate, "rounds_per_s_basic_phase17": basic_rate,
        "trace_over_basic": rate / basic_rate if basic_rate else None,
        "spans_per_round": len(spans) / TRACE_ROUNDS, "exported_bytes_per_round": exported / TRACE_ROUNDS,
        "round_ranges": len(ranges), "k1_launches_per_range": per_range, "k1_device_executions": len(device),
        "profiled_s": profiled_s, "profile_read_s": read_s, "launches": counts, "card": card}))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--profile", metavar="DIR",
        help="also profile two rounds each of smallcnn per-leaf topk, flat "
        "rotq and flat int8 and one round each of MobileNet per-leaf topk "
        "and flat rotq; write the tables to DIR",
    )
    ap.add_argument(
        "--only", choices=["kernels", "federation", "faults", "zoo", "sim", "disaster", "async", "obs", "trace"],
        help="run the device phase and this phase alone, and print no result line",
    )
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi, name, peaks = device_phase()
    profile_dir = Path(args.profile) if args.profile else None
    if args.only == "kernels":
        build_phase()
        kernel_phase(peaks)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only == "zoo":
        build_phase()
        zoo_reference_phase()
        zoo_phase(datasets.load("cifar100", "train", seed=0), smi, profile_dir)
        zoo2_reference_phase()
        data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
        zoo2_phase(data, smi, profile_dir)
        zoo3_reference_phase()
        zoo3_phase(data, smi, profile_dir)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only in ("obs", "trace"):
        build_phase()
        data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
        fed = Federation(bench_cfg("topk", "per_leaf", "mobilenet"), seed=0, data=data)
        fed.step()  # warm, as phase 6's engine is: cuDNN picks its algorithms in the first round
        if args.only == "obs":
            obs_phase(fed, smi)
        else:
            trace_phase(fed, smi)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only == "async":
        data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
        async_reference_phase()
        async_phase(data, smi)
        async_grpc_phase(data, smi)
        solo_phase(data, smi)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only in ("sim", "disaster"):
        build_phase()
        data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
        if args.only == "sim":
            sim_reference_phase()
            sim_phase(data, smi)
        else:
            drill = DisasterEngineDrill(data, smi)
            drill.start()
            drill.crash()
            disaster_grpc_phase(data, smi)
            drill.finish()
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only:
        data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
        {"federation": federation_phase, "faults": faults_phase}[args.only](data, smi)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    last = [time.perf_counter()]

    def clock(label):
        now = time.perf_counter()
        log(f"clock: {label} took {now - last[0]:.1f} s")
        last[0] = now

    build_phase()
    results = {"threshold_feedback": kernel_phase(peaks), "quantdequant_int8": int8_phase(peaks)}
    results["hadamard_rotate"] = hadamard_phase(peaks)
    clock("phases 1-3, device, build and kernels")
    reference_phase()
    mobilenet_reference_phase()
    options_reference_phase()
    clock("phases 4, 6 (reference) and 7")
    data = datasets.load("cifar10", "train", seed=0, num=NUM_CLIENTS * STEPS * BATCH)
    paths = {}
    feds, paths["smallcnn"] = slice_phase(data)
    for layout in ("per_leaf", "flat"):
        feds[("none", layout)] = Federation(bench_cfg("none", layout), seed=0, data=data)
        feds[("none", layout)].run_on_device(1)  # warm-up
    timing_phase(feds, smi)
    pack_phase(feds[("none", "flat")], peaks, smi)
    if args.profile:
        base, _ = profile_phase(feds[("topk", "per_leaf")], Path(args.profile), "per_leaf_topk")
        for codec in ("rotq", "int8"):
            label = f"flat_{codec}"
            profile_diff(base, profile_phase(feds[(codec, "flat")], Path(args.profile), label)[0],
                         label, "per_leaf_topk")
    del feds
    torch.cuda.empty_cache()
    clock("phase 5, the smallcnn slice")
    mfeds, paths["mobilenet"] = slice_phase(data, "mobilenet", MOBILENET_SLICE, MOBILENET_LEAVES)
    flops = model_flops()
    rates = timing_phase(mfeds, smi, MOBILENET_SLICE, MOBILENET_TIMED_ROUNDS, "mobilenet")
    for rate in rates.values():
        rate["model_tflop_per_round"] = flops / 1e12
        rate["model_tflop_per_s"] = flops * rate["rounds_per_s"] / 1e12
    log(f"mobilenet: {flops / 1e12:.3f} TFLOP of model FLOPs a round (3x the counted forward)")
    if args.profile:
        base, _ = profile_phase(mfeds[("topk", "per_leaf")], Path(args.profile), "mobilenet_per_leaf_topk", rounds=1)
        profile_diff(base, profile_phase(mfeds[("rotq", "flat")], Path(args.profile), "mobilenet_flat_rotq", rounds=1)[0],
                     "mobilenet_flat_rotq", "mobilenet_per_leaf_topk")
    clock("phase 6 (a), the MobileNet slice")
    paths["obs"], obs_rates = obs_phase(mfeds[("topk", "per_leaf")], smi)
    clock("phase 17, the observability plane on phase 6's per-leaf topk engine")
    paths["trace"] = trace_phase(mfeds[("topk", "per_leaf")], smi, obs_rates["basic"])
    clock("phase 18, the span tracer on the same engine")
    del mfeds
    torch.cuda.empty_cache()
    mobilenet_options_phase(data, smi)
    clock("phase 6 (b), MobileNet's options")
    _, paths["options"] = options_phase(data, smi)
    remat_probe(data, smi)
    clock("phase 8, the options")
    edge_reference_phase()
    edge_phase(data, smi)
    clock("phase 9, the edge")
    federation_phase(data, smi)
    clock("phase 10, the federation")
    faults_phase(data, smi)
    clock("phase 11, the faults")
    zoo_reference_phase()
    clock("phase 12 (a), the zoo's reference")
    _, paths["zoo"] = zoo_phase(datasets.load("cifar100", "train", seed=0), smi, profile_dir)
    clock("phase 12 (b)-(c), config 4 and DenseNet")
    zoo2_reference_phase()
    clock("phase 13 (a), the zoo's second part's reference")
    _, paths["zoo2"] = zoo2_phase(data, smi, profile_dir)
    clock("phase 13 (b)-(c), ShuffleNetV2 and MobileNetV2")
    zoo3_reference_phase()
    clock("phase 14 (a), the zoo's last part's reference")
    _, paths["zoo3"] = zoo3_phase(data, smi, profile_dir)
    clock("phase 14 (b), EfficientNet-B0")
    # The engine drill's writer compresses its generations beside the sim
    # phases and the gRPC drill.
    drill = DisasterEngineDrill(data, smi)
    drill.start()
    sim_reference_phase()
    paths["sim"] = sim_phase(data, smi)
    drill.crash()
    disaster_grpc_phase(data, smi)
    paths["disaster"] = drill.finish()
    clock("phase 15 (a)-(c), the sim engine and the disaster drills")
    async_reference_phase()
    paths["async"] = async_phase(data, smi)
    for kname, n in async_grpc_phase(data, smi).items():
        paths["async"][kname] += n
    paths["solo"] = solo_phase(data, smi)
    clock("phase 16, the async engine, run_async and the solo trainer")
    for kname in kernels.KERNELS:
        for path, counts in paths.items():
            if kname in PATH_KERNELS.get(path, kernels.KERNELS) and counts.get(kname, 0) == 0:
                raise RuntimeError(f"slice: {kname} was never launched on the {path} path")
        results[kname]["launches"] = sum(counts.get(kname, 0) for counts in paths.values())
        results[kname]["launches_by_path"] = {path: counts.get(kname, 0) for path, counts in paths.items()}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
