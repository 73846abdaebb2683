"""Smoke run of the PyTorch/CUDA port (elasticdl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero before the final line:
1. device: the card's name and power limit (nvidia-smi); CUDA must be there.
2. build: nvcc builds the flash-attention kernels from ops/csrc/ into
   build/torch_ext/.
3. kernels: each kernel against its plain PyTorch version at the flagship
   attention shape (f32 [4, 8, 4096, 128], causal) and at ragged shapes
   (S not a multiple of any tile, head sizes 32, 64 and 128), with kernel,
   plain-version and library (scaled_dot_product_attention) times from
   CUDA events; the forward (with lse), dQ and dK/dV kernels run twice on
   the flagship inputs and must give bitwise equal outputs, and every
   kernel is timed again on those inputs rounded to bfloat16 (the LM's
   attention inputs are bfloat16 values in f32 tensors, on which the
   kernels skip zero small parts). Beside each data-sheet bound stands the
   bound at the mma.sync TF32 rate that this run measures (mma_peak), the
   ceiling of the kernels' instruction.
4. reference: a small LM (head size 128, ragged S=300, float32) on the card,
   through the kernels, against the same weights on the CPU through the
   plain versions: logits, loss and every gradient.
5. train + eval, the direct path: LocalTrainer on the 222M flagship LM
   (S=4096, batch 4) takes 5 Adam steps on synthetic Markov tokens, then
   one evaluate_minibatch. Launch counts are reset just before and read
   just after; every kernel must have run there.
6. profile: one more train step under torch.profiler: device time by
   kernel group and the device's busy share of the step.
7. job, the main path through the control plane: the same flagship LM
   trained as an elastic job in this process. Record files (64 training,
   8 validation sequences) and a model-def file go to a temporary
   directory; Master(args) shards them into tasks of 16 records, and the
   Worker that build_worker(args, MasterClient(in-process stub)) assembles
   pulls tasks, reads and decodes records, trains minibatches of 4 and
   evaluates every 8 model versions, every request and response crossing
   the wire format. Launch counts are reset just before worker.run() and
   read just after, and must be exact; records_done, steps, logged losses
   and evaluation results are checked. The job runs journaled and
   observed: ELASTICDL_MASTER_JOURNAL_DIR, an obs dir with the master's
   one exporter advertised (role "master", on 127.0.0.1; the worker shares
   the process and its registry), --metrics_dir, ELASTICDL_POLICY=1. After
   minibatch 2 of 4 of training task 2 the master is dropped as a crash
   leaves it (threads gone, journal closed without compaction) and a
   successor is built over the same journal and prepared; the worker's
   stub reaches whichever master holds the place. The successor must
   replay to incarnation 2, log master_recovered and lease_reissued,
   accept the straddling report once; metrics.jsonl must hold every
   evaluation, the aggregator's records count equal the job's, and no
   policy decision apply and no alert fire. Prints the journal's ops, WAL
   bytes, ms per fsynced append, replay, compaction and snapshot sizes,
   and ms from dropping the master to the successor's first dispatch.
   Then a checkpoint round trip: save_trainer_checkpoint, restore into a
   fresh trainer through restore_on_init, eval logits bitwise equal.
8. moe_lm: the Switch-MoE LM (moe_lm.flagship_config: the flagship's
   widths, 4 experts in every second block, capacity factor 1.25,
   373,481,496 parameters). First a small float32 MoE LM on the card
   against the CPU: the routing of each MoE layer (expert and keep, from
   each side's own layer input) must be equal, else the differing tokens
   and their top-2 margins are printed and the phase fails; then logits,
   loss with its aux term and every gradient within 1e-4 of the largest.
   Then the flagship-width model on LocalTrainer (batch 4 x S 4096,
   Markov tokens, Adam): 2 warm-up and 3 timed steps (ms per step,
   tokens/s, peak memory), one evaluation, exact launch counts of all four
   kernels, one profiled step by kernel group with the MoE routing
   (router, cumsum, gather and scatter, forward and backward) and the
   expert products in groups of their own, and the busy share. Then the
   same model as a job through the master (32 + 4 records, tasks of 16, 8
   steps, one evaluation): records_done exact, exact launch counts,
   falling logged losses, then a checkpoint round trip with bitwise-equal
   eval logits.
9. ps_step, the parameter-server path direct: DeepFMCriteoPS at full width
   (39 fields over 5,546,673 shared ids, deep_dim 8, DNN (16, 4)) at batch
   16384 with its tables in 2 in-process PS shards (Adam), on four seeded
   id batches uniform over the id space. First one batch at the same
   weights on the card and on the CPU: loss, dense gradients and row
   gradients within 1e-5 of the largest value. Then five runs of 4 warm-up
   and 4 timed steps, one after the other: float32 and int8 wires inline,
   then float32 wire pipelined (push thread, lookahead pulls, row cache),
   bfloat16 wire pipelined, int8 wire pipelined (int8: dense gradients in
   int8 blocks with error feedback, bfloat16 rows); each prints
   examples/s, ms per step, the trainer's phase split, bytes to and from
   the card and pushed per step, the row cache's hit ratio, rows per table
   per shard and the device's busy share over one profiled step. Every
   push must be accepted and each shard's version equal the steps taken;
   the int8 inline run's loss on each timed step must be within 1e-3 of
   the float32 inline run's (the pipelined gap is printed: a push races
   the next step's pull, so pipelined runs do not repeat exactly).
10. ps_job, the parameter-server path through every layer: 262144 training
   and 4096 validation synthetic Criteo records in .edlr files, Master with
   ParameterServerStrategy and 2 shards, tasks and minibatches of 16384,
   evaluation every 8 versions, one worker from build_worker on the
   shards' in-process stubs: 16 steps, the records decoded column by
   column in the host library. After step 8 shard 0 is relaunched empty
   and re-seeded by the worker. records_done must be 262144, all 16 pushes
   accepted, evaluation must report auc and accuracy, the logged losses
   finite and falling. Then a PS checkpoint round trip: shards saved at
   the last version and restored into fresh shards give bitwise-equal eval
   outputs. Prints wall time, host share, host time by call (the feed's
   and the decode's ms per record among them) and checkpoint bytes, save
   and restore seconds.
11. ctr_zoo: DeepFM, wide & deep, DCN and xDeepFM with their tables on
   the card at full width (5,546,673 ids, D 8, DNN (16, 4), CIN (16, 16),
   3 cross layers), and deepctr's WDL (26 categoricals hashed on the
   card into 10000 buckets each, dim-4 deep and dim-1 wide embedding
   columns, DNN (128, 64)), on LocalTrainer, batch 16384 of Criteo records
   fed through the decode: 4 warm-up and 8 timed steps each (ms per step,
   examples/s), one profiled step (device time by kernel group, busy
   share), then one batch at the same weights on the card and on the
   CPU: loss within 1e-5 relative, every gradient within 1e-5 of its
   largest value.
12. lm_ps: the flagship LM (full width, 4 layers, batch 4 x S 4096) as a
   job through Master with ParameterServerStrategy and 2 shards, its model
   spec without embedding_inputs: tok_emb and pos_emb move to the PS and
   the ids feed is derived. One job on the float32 wire and one on the
   int8 wire, 4 steps each: records_done exact, every push accepted,
   losses falling, exact flash-attention launch counts (4 forward
   launches come from the capture forward that derives the feed); the
   export loaded into a stock TransformerLM gives the PS trainer's logits
   bitwise; on the float32 job's first batch the loss and the tok_emb and
   pos_emb row gradients equal a direct LocalTrainer step from the same
   weights (1e-5 / 1e-4 of the largest value). Prints the tables moved,
   ms per step and its phase split, payload bytes per push, the device's
   busy share over one profiled step, and the process's peak RSS.
13. zoo: the image and tabular zoo. ResNet-50 (batch 128) and MobileNetV2
   (batch 256) at 224x224, bf16 convs and f32 BatchNorm, on LocalTrainer:
   2 warm-up and 5 timed steps each (ms per step, img/s, peak memory, the
   step's model FLOPs over the bf16 data-sheet peak, losses falling), one
   profiled step by kernel group. ResNet-50 as a job through the master
   on 1024 training and 256 validation records of f32 images (tasks of
   256, minibatches of 128, evaluation every 4 versions): records_done
   exact, evaluation results, then a checkpoint round trip with its
   batch_stats (eval outputs bitwise equal). ResNet-50 on
   ParameterServerTrainer, 2 in-process shards, f32 wire, batch 128, its
   BatchNorm statistics on the worker: the first batch (cudnn
   deterministic) against a direct LocalTrainer step at the same weights
   (loss 1e-5, dense gradients 1e-4 of the largest, batch_stats 1e-5),
   then 2 warm-up and 2 timed steps (ms per step, phase split, bytes
   pushed, one profiled step's busy share), every push accepted, the
   batch_stats moved. Both models in f32 at batch
   2 on the card against the CPU (see _zoo_card_vs_cpu for the bounds).
   One short job through the master for each small zoo model (MNIST,
   CIFAR-10, census wide & deep, DNN and feature-column wide & deep,
   heart, iris from CSV, DeepFM, and DeepFM with both tables on 2 PS
   shards): records_done exact and the loss falling.
14. processes: the job across processes on the card. First the socket
   transport on loopback in this process (ms per small call, GB/s of a
   64 MiB push) and the record reader (native and Python ms per record).
   proc_lm: the flagship LM (64 training records, tasks of 16, training
   only) through `python -m elasticdl_tpu_torch.master.main` with the
   journal, --metrics_dir and two worker processes on the one card;
   at 16 records worker 0 is stopped (SIGSTOP) and worker 1 SIGKILLed
   and relaunched by the instance manager, so the tasks left wait for
   the relaunched worker; at 40 records (its work) worker 0 is continued
   and the master SIGKILLed, and master.main started again with
   --instance_backend none over the same journal and port; the orphaned
   workers finish the job with it. Checks records_done 64, one relaunch
   of worker 1 and a task it reported, incarnation 2 with
   master_recovered, both workers outliving the master, finite losses,
   no process left, and each worker process's kernel launches and
   accepted telemetry pushes as its exit line gives them; prints the
   recovery times (from the workers' trace spans and a port probe),
   each worker's ms per step, the pushes, the job's timeline and wall.
   proc_ps: DeepFM-PS on ps_job's data and sizes through master.main with
   two PS processes and one worker; shard 0 SIGKILLed at 65,536 records
   and relaunched on its port. Checks records_done, every evaluation in
   metrics.jsonl, one relaunch of shard 0, finite losses, accepted
   pushes from every process; prints the recovery times, ms per step
   beside the in-process ps_step f32 pipelined step, bytes per step over
   the socket and the wall beside ps_job's.
15. client: the user's entry points, `python -m
   elasticdl_tpu_torch.client.main`, each command with the master in its
   own process and one worker process on the card. `edl train` of the
   flagship (32 records in tasks of 16, training only, exported with
   --output), then `edl predict` of 8 records from that export, its model
   def adding a prediction-outputs processor that saves each minibatch's
   last-position logits; they must equal this process's forward of the
   same export within 1e-4 of the largest value. Then `edl train` and
   `edl evaluate` of the MNIST CNN (the flagship's evaluation report is
   over the transport's cap): its metrics must land in metrics.jsonl.
   Checks each worker's launches exactly from its exit line (the train
   worker 4 each of flash_fwd_lse, flash_dq, flash_dkv per step and no
   flash_fwd; the predict worker 4 flash_fwd per minibatch and nothing
   else); prints each command's wall time and its processes' timeline.
16. k8s: `edl train --instance_backend k8s` of the flagship (48 records
   in tasks of 16, one worker pod, training only) against
   tests/fake_k8s_server.py on loopback (EDL_K8S_API_SERVER). _Kubelet
   runs each pod created there as a local process and reports its phases;
   the client creates the master pod, the master pod's K8sInstanceManager
   the worker pod. After the worker's first accepted report its pod is
   SIGKILLed and reported Failed with exit code 137, reason Preempted; the
   master relaunches it as -r1, which trains the tasks left. Checks
   records_done 48, one relaunch, the master pod Succeeded, the
   TensorBoard service, no process left and the relaunched pod's
   launches; prints the time from the kill to the relaunched pod's first
   accepted report beside proc_lm's worker recovery.
17. allreduce: elastic AllReduce (gloo process groups; every gradient
   bucket staged through pinned host memory). In this process: the
   flagship on AllReduceTrainer in a one-process world takes 3 steps on
   the main path's batches, losses and weights bitwise equal to
   LocalTrainer's from the same seed; two trainers as threads form a
   world of 2 (the join gate, the rendezvous, rank 0's state broadcast),
   each on half of each batch of 4, on the flagship with float32
   activations: bitwise equal to each other, the first step's averaged
   gradients within 1e-4 of LocalTrainer's at batch 4 and the weights
   after 3 steps within 1e-4 of its largest value (plus the documented
   Adam term where a gradient is rounding noise); ms per step, the
   all-reduce's ms per leg and bytes. Then the MNIST CNN: a joiner pulls
   rank 0's state over the COLLECTIVE service, bitwise with its
   BatchNorm statistics. proc_ar: master.main --multi_host with two
   worker processes on 192 records in tasks of 16 (training only); after
   the first lease of the world of 2 worker 1 is SIGKILLed and relaunched,
   worker 0 regroups alone, is stopped after its first lease alone and
   continued once worker 1 has registered, and the two form a world again
   with the state sync. Checks records_done 192 (every record in one
   completed lease, the others aborted), one relaunch, increasing
   membership epochs, exact launches per rank process, the last world's
   equal version and weights' digest, no process left; prints the
   recovery times split and ms per step in each world.
18. model_axes: the model and seq axes of AllReduceTrainer, its shards as
   threads of this process sharing the card (ELASTICDL_LOCAL_DEVICES),
   their collectives on gloo through pinned host buffers. float32 checks
   at the flagship's widths and 4 layers, batch 4 x S 4096, one step
   each against LocalTrainer from the same seed and batch: TP2, SP2
   zigzag, SP2 ring, SP2 Ulysses, TP2 x SP2 zigzag (4 shards, heads split
   over the model axis), and the Switch-MoE LM over two model shards of
   2 experts each (EP2), its routing on each shard first, exactly; loss
   and every gathered gradient within 1e-4 of the tensor's largest value,
   each shard's launches exact (blocks visible per shard x layers). Then
   the bfloat16 flagship (12 layers) timed under LocalTrainer, TP2 and
   SP2 zigzag, one step each: ms per step, the gloo legs' seconds and bytes
   per axis, peak memory, the losses beside LocalTrainer's (reported, not
   bounded), exact launches. Then a --multi_host --model_parallel_size 2
   job through master.main, two worker processes of two model shards each
   on the card (32 records in tasks of 16, the flagship at 4 layers):
   records_done, each process's launches (2 shards x layers per step),
   equal version and digest, no process left.
19. data_axis: ZeRO-1, the quantized world of two ranks, DeepFM with its
   tables row-sharded, ResNet-50's BatchNorm over two shards, and a
   two-process --zero1 --quantized_grads job (see phase_data_axis).
20. pipeline: the stage axis of AllReduceTrainer (parallel/pipeline.py),
   two stage shards as threads of this process sharing the card, their
   hops on gloo. float32 checks at the flagship's widths and 4 layers,
   batch 4 x S 4096, one step each of GPipe (2 microbatches), 1F1B (2)
   and interleaved 1F1B (2 virtual stages, 4 microbatches) against
   LocalTrainer on the same weights moved into the staged tree through
   common/params.py: loss within 1e-5, every gradient within 1e-4 of its
   largest value, each stage's launches exact. The bfloat16 flagship (12
   layers) timed under LocalTrainer and each schedule at 4 microbatches,
   3 steps each: ms per step, the stage axis' gloo legs and bytes per
   step, peak memory, the losses beside LocalTrainer's, exact launches.
   The named remat policies on LocalTrainer (bfloat16, 12 layers), one
   forward and backward each on the same weights: every gradient bitwise
   or within 1e-6 of its largest value against remat off, peak memory and
   launches. Then a --multi_host --pipeline_stages 2 --pipeline_schedule
   1f1b job through master.main, two worker processes of two stage shards
   each (32 records in tasks of 16, the flagship at 4 layers): records,
   the world spec data=2,stage=2|pg|p2, "Initialized pipelined model" in
   each worker, each process's launches, equal version and digest, no
   process left.
The phases that repeat the flagship beyond the main path (proc_lm, client,
k8s, allreduce, lm_ps) run it at its full width and PROC_LAYERS (4)
layers.
The PS, CTR and zoo phases launch none of the flash-attention kernels;
their counts are reset before each and read after it. proc_lm's, the
client's and the k8s pods' kernels run in their worker processes: each
logs its counts at its exit, and the kernels line carries them as
proc_lm_launches, client_launches and k8s_launches; allreduce_launches has
the allreduce phase's in-process part and its rank processes;
model_axes_launches, data_axis_launches and pipeline_launches each
shard's of those phases' runs and each process's of their jobs. Then each
phase's seconds, the {"kernels": [...]} line, and last {"ok": true,
"device": {...}}.
"""

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import logging
import math
import os
import re
import resource
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.common import args as edl_args
from elasticdl_tpu_torch.common import rpc, tensor_utils
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    load_flax,
    monolithic_to_staged,
    params_from_flax,
    params_to_flax,
    staged_to_monolithic,
    state_to_flax,
)
from elasticdl_tpu_torch.common.save_utils import save_trainer_checkpoint
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.data.recordfile import RecordFile, RecordFileWriter
from elasticdl_tpu_torch.layers import moe as moe_layer
from elasticdl_tpu_torch.layers.conv import BatchNorm, Conv
from elasticdl_tpu_torch.master import journal as master_journal
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.models.census import dnn as census_dnn
from elasticdl_tpu_torch.models.census import wide_deep as census_wide_deep
from elasticdl_tpu_torch.models.census_fc import wide_deep_fc as census_fc
from elasticdl_tpu_torch.models.dac_ctr import (
    dcn,
    deepfm,
    deepfm_ps,
    transform as criteo_transform,
    wide_deep,
    xdeepfm,
)
from elasticdl_tpu_torch.models.dac_ctr.transform import NUM_FIELDS, TOTAL_IDS
from elasticdl_tpu_torch.models.deepctr import wdl
from elasticdl_tpu_torch.models.deepfm import deepfm_functional
from elasticdl_tpu_torch.models.heart import heart_model
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.models.iris import iris_dnn
from elasticdl_tpu_torch.models.mobilenetv2 import mobilenetv2
from elasticdl_tpu_torch.models.resnet50 import resnet50
from elasticdl_tpu_torch.models.transformer import moe_lm
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import mma_peak
from elasticdl_tpu_torch.parallel import distributed
from elasticdl_tpu_torch.parallel.sharded_embedding import (
    padded_vocab,
    shard_table_rows,
)
from elasticdl_tpu_torch.parallel.shards import run_group
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.ps import checkpoint as ps_checkpoint
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker import allreduce_trainer as art
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

# H100 SXM data-sheet peaks (dense). An f32 product takes either f32 FMA
# on the CUDA cores or three TF32 tensor-core products (3xTF32, the same
# f32 accuracy): its least time is the lesser of the two.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_HBM_BYTES = 3.35e12

FLAGSHIP_ATTN = (4, 8, 4096, 128)
# Kernel vs plain version. float32: the same arithmetic summed in another
# order (3xTF32 tensor-core products in the kernels, cuBLAS in the plain
# version). bfloat16:
# outputs are rounded to bf16 (8-bit mantissa) on both sides, and values
# reach magnitude ~2, where one bf16 ulp is 2**-6.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RAGGED_CASES = [
    ((2, 4, 1000, 128), False, torch.float32),
    ((2, 3, 1000, 64), True, torch.float32),
    ((1, 2, 333, 128), True, torch.bfloat16),
    ((2, 4, 1000, 32), True, torch.float32),
    ((1, 3, 333, 32), False, torch.bfloat16),
]
SOURCES = {
    "flash_fwd": ("elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
                  "elasticdl_tpu/ops/flash_attention.py:107"),
    "flash_fwd_lse": ("elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
                      "elasticdl_tpu/ops/flash_attention.py:107"),
    "flash_dq": ("elasticdl_tpu_torch/ops/csrc/flash_dq.cu",
                 "elasticdl_tpu/ops/flash_attention.py:246"),
    "flash_dkv": ("elasticdl_tpu_torch/ops/csrc/flash_dkv.cu",
                  "elasticdl_tpu/ops/flash_attention.py:285"),
}
# Tile products per kernel: QK^T and PV; + dO V^T and dS K; + dO V^T and
# dS^T Q beside P^T dO.
PRODUCTS = {"flash_fwd": 2, "flash_fwd_lse": 2, "flash_dq": 3,
            "flash_dkv": 4}
# TF32 tensor-core products the kernels need when Q, K, V and dO are exact
# in TF32 (bfloat16 values in f32 tensors, as the LM hands them over): one
# for each score product, two where P or dS is an operand. On other f32
# inputs every product takes three (3xTF32).
EXACT_TF32_PRODUCTS = {"flash_fwd": 1 + 2, "flash_fwd_lse": 1 + 2,
                       "flash_dq": 1 + 1 + 2, "flash_dkv": 1 + 1 + 2 + 2}

TRAIN_STEPS = 5
BATCH = 4
SEQ = 4096
# The job phase: 64 training records in tasks of 16 (4 tasks, 16 steps of
# 4), 8 validation records evaluated every 8 model versions (at versions 8
# and 16, 2 minibatches each), the loss logged every 4 steps.
JOB_TRAIN_RECORDS = 64
JOB_VALID_RECORDS = 8
JOB_RECORDS_PER_TASK = 16
JOB_EVAL_STEPS = 8
JOB_LOG_STEPS = 4
MODEL_DEF = """\
import dataclasses as _dc

from elasticdl_tpu_torch.models.transformer import transformer_lm as _lm
from elasticdl_tpu_torch.models.transformer.transformer_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer, param_specs,
)


def custom_model():
    return _lm.custom_model(_dc.replace(_lm.flagship_config({seq}),
                                        n_layers={layers}))


def pipeline_spec(**kw):
    return _lm.pipeline_spec(
        config=_dc.replace(_lm.flagship_config({seq}), n_layers={layers}),
        **kw)
"""
# The phases that repeat the flagship beyond the main path (proc_lm,
# client, k8s, allreduce, lm_ps) run it at full width and this depth: what
# they check and time is processes, recovery, the transport and the
# collectives, and the script's time limit is shared with the model_axes
# phase.
PROC_LAYERS = 4


def proc_config():
    """The flagship's widths at PROC_LAYERS layers."""
    return dataclasses.replace(tlm.flagship_config(SEQ),
                               n_layers=PROC_LAYERS)

# The Switch-MoE LM at the flagship's widths with 4 experts in every second
# block (moe_lm.flagship_config: 373,481,496 parameters, capacity 5120 per
# expert at batch 4 x S 4096), Adam 3e-4 on Markov tokens: 2 warm-up and 3
# timed steps on LocalTrainer, one evaluation, one profiled step. Then a
# job through the master: 32 training and 4 validation records, tasks of
# 16, minibatches of 4 (8 steps), evaluation at version 8, the loss logged
# every 2 steps; then a checkpoint round trip.
MOE_PARAMS = 373_481_496
MOE_WARMUP = 2
MOE_STEPS = 3
MOE_JOB_TRAIN = 32
MOE_JOB_VALID = 4
MOE_JOB_TASK = 16
MOE_JOB_EVAL_STEPS = 8
MOE_JOB_LOG_STEPS = 2
MOE_MODEL_DEF = """\
from elasticdl_tpu_torch.models.transformer import moe_lm as _m
from elasticdl_tpu_torch.models.transformer.moe_lm import (  # noqa
    eval_metrics_fn, feed, loss, optimizer,
)


def custom_model():
    return _m.custom_model(_m.flagship_config({seq}))
"""
# Card against CPU: a float32 MoE LM with head size 128 (Block_0, then
# MoEBlock_0), batch 2 at a ragged S of 300 (600 tokens, capacity 187 per
# expert); each value as a share of the largest value compared (a gradient:
# of its parameter's largest), once the routing is equal on both sides.
MOE_CHECK_CONFIG = dict(vocab=512, d_model=256, n_heads=2, n_layers=2,
                        max_len=512, activation_dtype="float32")
MOE_CHECK_SEQ = 300
MOE_CHECK_RTOL = 1e-4
MOE_RANGES = (moe_layer.ROUTING_RANGE, moe_layer.EXPERTS_RANGE)
# torch's RecordScope::BACKWARD_FUNCTION: an autograd node's own event;
# the engine's event around it carries the node's number too.
_BACKWARD_SCOPE = 1
_BACKWARD_ENGINE = "autograd::engine::"

# The parameter-server phases: DeepFM-PS as the JAX package's PS bench runs
# it (bench/workloads.py: batch 16384, 2 shards, 4 distinct id batches, 4
# warm-up steps so the timed steps meet warm rows), and a job through the
# master with tasks and minibatches of 16384 records (16 steps; the records
# are decoded column by column in the host library).
PS_SPEC = "elasticdl_tpu_torch.models.dac_ctr.deepfm_ps"
PS_BATCH = 16384
PS_SHARDS = 2
PS_WARMUP = 4
PS_STEPS = 4
# f32 and bf16 pipelined run one after the other in one process, so their
# comparison shares the host's state; int8 follows them.
PS_RUNS = (("f32_inline", "float32", False),
           ("int8_inline", "int8", False),
           ("f32_pipelined", "float32", True),
           ("bf16_pipelined", "bfloat16", True),
           ("int8_pipelined", "int8", True))
# Card against CPU: the same float32 arithmetic summed in another order,
# as a share of the largest value compared.
PS_CHECK_RTOL = 1e-5
# The int8 wire's loss on each timed step against the f32 wire's on the same
# batches from the same weights, both inline: int8 dense gradients (error
# feedback) and bfloat16 rows move a BCE loss of ~0.8 by far less than this.
# Inline runs repeat exactly; pipelined ones do not (a push races the next
# step's pull, so which version a step reads depends on timing: two f32
# pipelined runs differed by 2.3e-3 in their last loss), so the pipelined
# gap is printed, not held to this bound.
PS_INT8_LOSS_ATOL = 1e-3
PS_JOB_BATCH = 16384
PS_JOB_STEPS = 16
PS_JOB_TRAIN = PS_JOB_STEPS * PS_JOB_BATCH
PS_JOB_VALID = 4096
PS_JOB_TASK = PS_JOB_BATCH
PS_JOB_EVAL_STEPS = 8
PS_RESEED_AFTER = 8

# The device-resident CTR family at full width: V = 5,546,673 shared ids,
# D = 8, DNN (16, 4), CIN (16, 16), 3 cross layers; batch 16384 of Criteo
# records fed through the decode, 2 distinct batches, 4 warm-up and 8 timed
# steps on LocalTrainer.
CTR_HEADS = (("deepfm", deepfm), ("wide_deep", wide_deep), ("dcn", dcn),
             ("xdeepfm", xdeepfm), ("wdl", wdl))
CTR_BATCH = 16384
CTR_WARMUP = 4
CTR_STEPS = 8
# Card against CPU on one batch from the same weights: loss relative,
# gradients as a share of each parameter's largest gradient.
CTR_CHECK_RTOL = 1e-5

# The flagship LM on the parameter server: its model spec declares no
# embedding_inputs, so tok_emb and pos_emb move to 2 in-process shards and
# the ids feed is derived. One job per wire, each 4 steps of 4 sequences
# from .edlr records (tasks of 8), the loss logged every step.
LM_PS_WIRES = ("float32", "int8")
LM_PS_STEPS = 4
LM_PS_TASK = 8
# (c): the first batch through the PS path against a direct LocalTrainer
# step from the same weights: the loss relative, the tok_emb row gradients
# as a share of their largest (float32 sums in another order).
LM_PS_LOSS_RTOL = 1e-5
LM_PS_GRAD_RTOL = 1e-4

# The image zoo at full width: ResNet-50 (batch 128, as the JAX package's
# throughput workload) and MobileNetV2 (batch 256), 224x224, bf16 convs;
# 2 warm-up and 5 timed steps on 2 distinct batches of synthetic images
# (ZOO_CLASSES templates plus noise, labels under the 1000-way head).
PEAK_BF16_FLOPS = 989e12
ZOO_IMAGE = 224
ZOO_CLASSES = 10
ZOO_WARMUP = 2
ZOO_STEPS = 5
ZOO_DIRECT = (("resnet50", resnet50, 128), ("mobilenetv2", mobilenetv2, 256))
# ResNet-50 through the master: 1024 training and 256 validation records
# of float32 images, tasks of 256, minibatches of 128, evaluation every 4
# versions (8 steps; evaluations at 4 and 8).
ZOO_JOB_TRAIN = 1024
ZOO_JOB_VALID = 256
ZOO_JOB_TASK = 256
ZOO_JOB_BATCH = 128
ZOO_JOB_EVAL_STEPS = 4
# ResNet-50 on ParameterServerTrainer: 2 in-process shards, the f32 wire,
# batch 128, 2 warm-up and 2 timed steps; its first batch against a direct
# LocalTrainer step at the same weights (loss relative, dense gradients as
# a share of the push's largest, batch_stats as a share of each tensor's
# largest).
ZOO_PS_BATCH = 128
ZOO_PS_SHARDS = 2
ZOO_PS_WARMUP = 2
ZOO_PS_STEPS = 2
ZOO_PS_LOSS_RTOL = 1e-5
ZOO_PS_GRAD_RTOL = 1e-4
ZOO_PS_STATS_RTOL = 1e-5
# Card against CPU: float32 models at batch 2, each value as a share of the
# largest value compared, a parameter gradient as a share of the model's
# largest gradient (the same arithmetic summed in another order).
ZOO_CHECK_BATCH = 2
ZOO_CHECK_RTOL = 1e-4
# The whole model's gradients: the card's may lie at most this many times
# as far from the float64 CPU gradients as the float32 CPU's do.
ZOO_CHECK_EXACT_RATIO = 4
# The small zoo through the master on the card: name -> (model def, its
# module (records), strategy); 128 records, 8 epochs of minibatches of 32.
ZOO_SMALL = {
    "mnist": ("elasticdl_tpu_torch.models.mnist.mnist_model", None,
              "Local"),
    "cifar10": ("elasticdl_tpu_torch.models.cifar10.cifar10_cnn", None,
                "Local"),
    "census_wide_deep": ("elasticdl_tpu_torch.models.census.wide_deep",
                         census_wide_deep, "Local"),
    "census_dnn": ("elasticdl_tpu_torch.models.census.dnn", census_dnn,
                   "Local"),
    "census_fc": ("elasticdl_tpu_torch.models.census_fc.wide_deep_fc",
                  census_fc, "Local"),
    "heart": ("elasticdl_tpu_torch.models.heart.heart_model", heart_model,
              "Local"),
    "iris": ("elasticdl_tpu_torch.models.iris.iris_dnn", None, "Local"),
    "deepfm_functional": (
        "elasticdl_tpu_torch.models.deepfm.deepfm_functional",
        deepfm_functional, "Local"),
    "deepfm_distributed": (
        "elasticdl_tpu_torch.models.deepfm.deepfm_distributed",
        deepfm_functional, "ParameterServerStrategy"),
}
ZOO_SMALL_RECORDS = 128
ZOO_SMALL_EPOCHS = 8
ZOO_SMALL_BATCH = 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn over `iters` calls after one warm-up call."""
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


def max_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / max(scale, 1e-30)


# ---------- phases ----------


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    # Plain versions and the model's float32 products in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", **info})
    return info


def phase_build():
    """Builds the kernels and the mma.sync rate probe (all nvcc processes
    at once), then measures that rate: the TF32 ceiling of the kernels'
    instruction with one block per SM, as the kernels run."""
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        probe = pool.submit(mma_peak._library)
        built = _build.build()
        probe_fn = probe.result()
    for name in _build.KERNELS:
        _build.library(name)
    seconds = time.perf_counter() - start
    peak = mma_peak.measure(probe_fn, mma_peak.ONE_BLOCK_PER_SM)
    emit({"phase": "build", "seconds": seconds, "built": built,
          "dir": _build.BUILD_DIR, "mma_sync": peak})
    return peak["mma_tf32_tflops"] * 1e12


def _attention_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(4)]


def _run_all(q, k, v, g, causal):
    """Every kernel and its plain version on one input set."""
    out, lse = fa.flash_fwd(q, k, v, causal, emit_lse=True)
    out_nolse, _ = fa.flash_fwd(q, k, v, causal, emit_lse=False)
    ref_out, ref_lse = fa._fwd_plain(q, k, v, causal)
    delta = fa._delta(g, out)
    dq = fa.flash_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, causal)
    ref_dq = fa._dq_plain(q, k, v, g, lse, delta, causal)
    ref_dk, ref_dv = fa._dkv_plain(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    return {
        "flash_fwd": [max_err(out_nolse, ref_out)],
        "flash_fwd_lse": [max_err(out, ref_out), max_err(lse, ref_lse)],
        "flash_dq": [max_err(dq, ref_dq)],
        "flash_dkv": [max_err(dk, ref_dk), max_err(dv, ref_dv)],
    }


def _check_errors(errors, tol, where):
    for name, pairs in errors.items():
        worst = max(abs_err for abs_err, _ in pairs)
        if not worst <= tol:
            raise AssertionError(
                f"{name} disagrees with its plain version at {where}: "
                f"max abs err {worst} > {tol}"
            )


def _pairs(shape, causal):
    """(q, k) pairs the mask lets through."""
    b, h, s, _ = shape
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def _bound(name, shape, causal, dtype):
    """(bound_ms, bound_by, flops, bytes, {unit: ms}): the larger of the
    compulsory bytes over HBM bandwidth and the tile-product FLOPs over the
    faster f32-accurate unit (3xTF32 tensor cores); the f32-FMA time is
    reported beside it."""
    b, h, s, d = shape
    bh = b * h
    flops = PRODUCTS[name] * 2 * d * _pairs(shape, causal)
    elem = torch.finfo(dtype).bits // 8
    mat = bh * s * d * elem
    row = bh * s * 4
    nbytes = {
        "flash_fwd": 4 * mat,
        "flash_fwd_lse": 4 * mat + row,
        "flash_dq": 5 * mat + 2 * row,
        "flash_dkv": 6 * mat + 2 * row,
    }[name]
    units = {"f32_fma_ms": flops / PEAK_F32_FLOPS * 1e3,
             "3xtf32_ms": flops / PEAK_3XTF32_FLOPS * 1e3}
    t_ops = min(units.values())
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes, units
    return t_bytes, "bytes", flops, nbytes, units


def _library_times(q, k, v, g, causal):
    """One PyTorch call per function where one exists (timed here only as
    a yardstick; the port never calls them)."""
    lib = {"flash_fwd": None, "flash_fwd_lse": None, "flash_dq": None,
           "flash_dkv": None}
    with torch.no_grad():
        lib["flash_fwd"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            10,
        )
        try:  # the efficient-attention op also returns the log-sum-exp
            lib["flash_fwd_lse"] = cuda_ms(
                lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    q, k, v, None, True, 0.0, causal
                ),
                10,
            )
        except (RuntimeError, AttributeError) as e:
            print(f"no lse-returning attention op: {e}", file=sys.stderr)
    # dQ alone and dK/dV alone have no single PyTorch call; SDPA's backward
    # computes all three gradients in one call.
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
    sdpa_bwd = cuda_ms(
        lambda: torch.autograd.grad(out, (qr, kr, vr), g, retain_graph=True),
        5,
    )
    return lib, sdpa_bwd


def _check_deterministic(q, k, v, g, lse, delta, causal):
    """The forward (with lse), dQ and dK/dV twice on the same inputs:
    bitwise equal outputs."""
    runs = [(*fa.flash_fwd(q, k, v, causal, emit_lse=True),
             fa.flash_dq(q, k, v, g, lse, delta, causal),
             *fa.flash_dkv(q, k, v, g, lse, delta, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
    emit({"phase": "kernels", "deterministic": dict(zip(
        ("flash_fwd_lse.out", "flash_fwd_lse.lse", "flash_dq",
         "flash_dkv.dk", "flash_dkv.dv"), equal))})
    if not all(equal):
        raise AssertionError("the kernels are not deterministic")


def _exact_inputs(q, k, v, g, causal, mma_flops):
    """Every kernel on the flagship inputs rounded to bfloat16, in f32
    tensors as the LM's path gives them (the kernels then skip the MMAs of
    zero small parts): error against the plain version, time, the bound of
    the work those inputs need (data sheet, and at the mma.sync rate
    measured in this run), and the library calls on the same inputs."""
    q, k, v, g = (t.bfloat16().float() for t in (q, k, v, g))
    out, lse = fa.flash_fwd(q, k, v, causal, emit_lse=True)
    delta = fa._delta(g, out)
    args = (q, k, v, g, lse, delta, causal)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, False)[:1],
                      lambda: (fa.reference_attention(q, k, v, causal),)),
        "flash_fwd_lse": (lambda: fa.flash_fwd(q, k, v, causal, True),
                          lambda: fa._fwd_plain(q, k, v, causal)),
        "flash_dq": (lambda: (fa.flash_dq(*args),),
                     lambda: (fa._dq_plain(*args),)),
        "flash_dkv": (lambda: fa.flash_dkv(*args),
                      lambda: fa._dkv_plain(*args)),
    }
    d = q.shape[-1]
    pairs = _pairs(q.shape, causal)
    result = {}
    for name, (kernel, plain) in fns.items():
        err = max(max_err(x, y)[0] for x, y in zip(kernel(), plain()))
        if not err <= TOL[torch.float32]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on bfloat16-exact inputs: {err}")
        ms = cuda_ms(kernel, 10)
        nbytes = _bound(name, q.shape, causal, torch.float32)[3]
        tf32_flops = EXACT_TF32_PRODUCTS[name] * 2 * d * pairs
        t_bytes = nbytes / PEAK_HBM_BYTES
        result[name] = {
            "ms": ms, "max_abs_err": err,
            "bound_ms": 1e3 * max(tf32_flops / PEAK_TF32_FLOPS, t_bytes),
            "mma_sync_bound_ms": 1e3 * max(tf32_flops / mma_flops, t_bytes)}
    library, result["sdpa_backward_ms"] = _library_times(q, k, v, g, causal)
    result["library_ms"] = library
    return result


def phase_kernels(mma_flops):
    emit({"phase": "kernels", "names": list(fa.KERNEL_NAMES)})
    for shape, causal, dtype in RAGGED_CASES:
        errors = _run_all(*_attention_inputs(shape, dtype, seed=1), causal)
        _check_errors(errors, TOL[dtype], f"{shape} causal={causal}")
        emit({"phase": "kernels", "shape": shape, "causal": causal,
              "dtype": str(dtype), "tolerance": TOL[dtype],
              "max_abs_rel_err": errors})

    shape, causal, dtype = FLAGSHIP_ATTN, True, torch.float32
    q, k, v, g = _attention_inputs(shape, dtype, seed=0)
    errors = _run_all(q, k, v, g, causal)
    _check_errors(errors, TOL[dtype], f"{shape} causal={causal}")

    out, lse = fa.flash_fwd(q, k, v, causal, emit_lse=True)
    delta = fa._delta(g, out)
    _check_deterministic(q, k, v, g, lse, delta, causal)
    kernel_fns = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal, False),
        "flash_fwd_lse": lambda: fa.flash_fwd(q, k, v, causal, True),
        "flash_dq": lambda: fa.flash_dq(q, k, v, g, lse, delta, causal),
        "flash_dkv": lambda: fa.flash_dkv(q, k, v, g, lse, delta, causal),
    }
    plain_fns = {
        "flash_fwd": lambda: fa.reference_attention(q, k, v, causal),
        "flash_fwd_lse": lambda: fa._fwd_plain(q, k, v, causal),
        "flash_dq": lambda: fa._dq_plain(q, k, v, g, lse, delta, causal),
        "flash_dkv": lambda: fa._dkv_plain(q, k, v, g, lse, delta, causal),
    }
    library, sdpa_bwd_ms = _library_times(q, k, v, g, causal)
    exact = _exact_inputs(q, k, v, g, causal, mma_flops)
    report = {}
    for name in fa.KERNEL_NAMES:
        ms = cuda_ms(kernel_fns[name], 10)
        plain_ms = cuda_ms(plain_fns[name], 3)
        bound_ms, bound_by, flops, nbytes, units = _bound(name, shape,
                                                          causal, dtype)
        # 3xTF32: three TF32 products per product at the mma.sync rate.
        mma_bound_ms = 1e3 * max(3 * flops / mma_flops,
                                 nbytes / PEAK_HBM_BYTES)
        report[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": None,  # filled from the main path's run
            "max_abs_err": max(e for e, _ in errors[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library[name],
            "mma_sync_bound_ms": mma_bound_ms,
            "bf16_exact_ms": exact[name]["ms"],
            "bf16_exact_bound_ms": exact[name]["bound_ms"],
            "bf16_exact_mma_sync_bound_ms": exact[name]["mma_sync_bound_ms"],
            "bf16_exact_library_ms": exact["library_ms"][name],
        }
        emit({"phase": "kernels", "kernel": name, "shape": shape,
              "causal": causal, "dtype": str(dtype),
              "tolerance": TOL[dtype], "max_abs_rel_err": errors[name],
              "tflops": flops / ms / 1e9, "flops": flops, "bytes": nbytes,
              "bound_by_unit_ms": units,
              "bf16_exact_inputs": exact.get(name),
              **{k: report[name][k] for k in (
                  "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "mma_sync_bound_ms")}})
    emit({"phase": "kernels", "sdpa_backward_ms": sdpa_bwd_ms,
          "flash_dq_plus_dkv_ms": report["flash_dq"]["ms"]
          + report["flash_dkv"]["ms"],
          "bf16_exact_inputs": {
              "sdpa_backward_ms": exact["sdpa_backward_ms"],
              "flash_dq_plus_dkv_ms": exact["flash_dq"]["ms"]
              + exact["flash_dkv"]["ms"]}})
    return report


def phase_reference():
    """The small LM through the kernels on the card against the same
    weights through the plain versions on the CPU (float32 activations)."""
    cfg = tlm.LMConfig(vocab=512, d_model=256, n_heads=2, n_layers=2,
                       max_len=512, activation_dtype="float32")
    cpu = tlm.custom_model(cfg).to_empty(device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = tlm.custom_model(cfg).to_empty(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tokens = synthetic_lm_tokens(2, 300, vocab=cfg.vocab, seed=1)
    x, y = torch.from_numpy(tokens[:, :-1]), torch.from_numpy(tokens[:, 1:])

    def run(model, device):
        logits = model(x.to(device))
        loss = tlm.loss(y.to(device), logits)
        loss.backward()
        return logits.detach().cpu(), loss.item()

    fa.reset_launch_counts()
    logits_gpu, loss_gpu = run(gpu, "cuda")
    launched = dict(fa.launches)
    logits_cpu, loss_cpu = run(cpu, "cpu")
    logits_err = float((logits_gpu - logits_cpu).abs().max())
    grads_gpu, grads_cpu = params_to_flax(_grads_as_params(gpu)), \
        params_to_flax(_grads_as_params(cpu))
    grad_rel = max(
        float(np.abs(grads_gpu[n] - grads_cpu[n]).max())
        / max(float(np.abs(grads_cpu[n]).max()), 1e-30)
        for n in grads_cpu
    )
    result = {"phase": "reference", "launches": launched,
              "logits_max_abs_err": logits_err,
              "loss_gpu": loss_gpu, "loss_cpu": loss_cpu,
              "grad_max_rel_err": grad_rel,
              "tolerance": {"logits": 1e-4, "loss": 1e-5, "grad_rel": 1e-4}}
    emit(result)
    if not (logits_err <= 1e-4 and abs(loss_gpu - loss_cpu) <= 1e-5
            and grad_rel <= 1e-4):
        raise AssertionError("the LM on the card disagrees with the CPU")
    if not all(launched.get(n) for n in
               ("flash_fwd_lse", "flash_dq", "flash_dkv")):
        raise AssertionError(f"the kernels did not run: {launched}")


def _grads_as_params(model):
    """A copy of `model` whose parameters hold its gradients."""
    grads = copy.deepcopy(model)
    for p, src in zip(grads.parameters(), model.parameters()):
        p.data = src.grad
    return grads


def phase_main_path():
    """LocalTrainer on the flagship LM: train steps, then one evaluation."""
    cfg = tlm.flagship_config(SEQ)
    trainer = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer())
    tokens = synthetic_lm_tokens(4 * BATCH, SEQ, vocab=cfg.vocab,
                                 branching=4, seed=0)
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launch_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        rows = slice((i % 4) * BATCH, (i % 4 + 1) * BATCH)
        start = time.perf_counter()
        _, version, loss = trainer.train_minibatch(tokens[rows, :-1],
                                                   tokens[rows, 1:])
        losses.append(loss.item())  # waits for the step
        step_s.append(time.perf_counter() - start)
    train_launches = dict(fa.launches)
    start = time.perf_counter()
    logits = trainer.evaluate_minibatch(tokens[:BATCH, :-1])
    eval_s = time.perf_counter() - start
    launches = dict(fa.launches)

    n_params = sum(p.numel() for p in trainer._model.parameters())
    steady = step_s[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    emit({"phase": "train", "params": n_params, "batch": BATCH,
          "seq": SEQ, "losses": losses, "version": version,
          "first_step_ms": 1e3 * step_s[0], "step_ms": step_ms,
          "tokens_per_s": BATCH * SEQ / (step_ms / 1e3),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": train_launches})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses}")

    metric = tlm.eval_metrics_fn()["token_ce"]
    metric.update(logits, tokens[:BATCH, 1:])
    emit({"phase": "eval", "shape": list(logits.shape),
          "finite": bool(np.isfinite(logits).all()), "eval_ms": 1e3 * eval_s,
          "token_ce": metric.result(), "launches": launches})
    if logits.shape != (BATCH, SEQ, cfg.vocab):
        raise AssertionError(f"eval logits have shape {logits.shape}")
    if not np.isfinite(logits).all():
        raise AssertionError("eval logits are not finite")

    expected = {"flash_fwd_lse": cfg.n_layers * TRAIN_STEPS,
                "flash_dq": cfg.n_layers * TRAIN_STEPS,
                "flash_dkv": cfg.n_layers * TRAIN_STEPS,
                "flash_fwd": cfg.n_layers}
    if launches != expected:
        raise AssertionError(
            f"main-path launches {launches}, expected {expected}"
        )
    _profile_step(trainer, tokens[:BATCH, :-1], tokens[:BATCH, 1:])
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": BATCH * SEQ / (step_ms / 1e3)}


def _kernel_group(name):
    if "edl_flash::" in name:
        return name.split("edl_flash::")[1].split("<")[0]
    low = name.lower()
    for group, keys in (("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
                        ("optimizer", ("multi_tensor", "adam")),
                        ("softmax_ce", ("softmax", "nll", "cross_entropy"))):
        if any(key in low for key in keys):
            return group
    return "other"


def _name_groups(prof, classify):
    """Device us by kernel group (`classify` names a kernel's group), the
    busy us (their sum), and the largest kernels of group "other"."""
    groups, other = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = classify(evt.key)
        groups[group] = groups.get(group, 0.0) + evt.self_device_time_total
        if group == "other":
            other.append((evt.self_device_time_total / 1e3, evt.count,
                          evt.key[:90]))
    return groups, sum(groups.values()), {
        "largest_other_ms_count_name": sorted(other, reverse=True)[:6]}


def _profile_step(trainer, features, labels, classify=_kernel_group,
                  phase="profile", device_groups=None):
    """One more train step (after the main path's counts were read) under
    torch.profiler: device time by kernel group and the device's busy
    share of the step's wall time. `device_groups(prof)` -> (us by group,
    busy us, extra fields) replaces the grouping by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.train_minibatch(features, labels)[2].item()
        wall_ms = 1e3 * (time.perf_counter() - start)
    groups, busy_us, extra = (device_groups(prof) if device_groups
                              else _name_groups(prof, classify))
    busy_ms = busy_us / 1e3
    result = {
        "phase": phase, "step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "device_busy_share": busy_ms / wall_ms if busy_ms else None,
        "device_ms_by_group": {
            g: t / 1e3 for g, t in sorted(groups.items(),
                                          key=lambda kv: -kv[1])},
        **extra}
    emit(result)
    return result


class _LossLog(logging.Handler):
    """Collects the worker's loss log lines ("Step %d (version %d) loss
    %.6f") with the host time each was written: the loss is materialized
    there, so each line is also the moment the card finished that step."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if record.msg.startswith("Step ") and len(record.args) == 3:
            step, _, loss = record.args
            self.lines.append((step, float(loss), time.perf_counter()))


@contextlib.contextmanager
def _logged_losses():
    """The worker's loss log lines, as _LossLog collects them, while the
    block runs."""
    loss_log = _LossLog()
    logger = logging.getLogger("elasticdl_tpu_torch.worker.worker")
    logger.addHandler(loss_log)
    try:
        yield loss_log.lines
    finally:
        logger.removeHandler(loss_log)


def _job(common, worker_extra, num_ps=0, place=None):
    """A job in this process: its Master (the `common` arguments, no
    instance backend; with num_ps, ParameterServerStrategy's in-process
    shards behind it) and worker 0 (`common` and `worker_extra`, on the
    shards' stubs where there are shards). With `place` (a _MasterPlace)
    the master is prepared and put there, and the worker reaches it
    through the place. Returns (master, the worker's MasterClient,
    worker)."""
    master = Master(_master_args(common, num_ps))
    if place is None:
        stub = master.stub()
    else:
        place.master = master.prepare()
        stub = rpc.InProcessStub(place, rpc.MASTER_SERVICE)
    client = MasterClient(stub, 0)
    worker_args = edl_args.worker_parser().parse_args(
        common + ["--worker_id", "0", "--master_addr", "in-process"]
        + worker_extra)
    edl_args.validate_args(worker_args)
    worker = build_worker(worker_args, client,
                          ps_stubs=master.ps_stubs() if num_ps else None)
    return master, client, worker


def _master_args(common, num_ps=0):
    extra = ["--instance_backend", "none"]
    if num_ps:
        extra += ["--num_ps", str(num_ps)]
    args = edl_args.master_parser().parse_args(common + extra)
    edl_args.validate_args(args)
    return args


class _MasterPlace:
    """The servicer at the master's place, in one process: hands each call
    to whichever Master holds the place now, as a relaunched master comes
    back on the same address, and notes when the first task after a
    relaunch went out."""

    def __init__(self):
        self.master = None
        self.relaunched_at = None  # perf_counter when the master dropped
        self.first_dispatch_s = None  # ... to the successor's first task

    def __getattr__(self, method):
        handler = getattr(self.master.servicer, method)
        if method != "get_task" or self.relaunched_at is None:
            return handler

        def get_task(request, context):
            task = handler(request, context)
            if task.task_id >= 0 and self.first_dispatch_s is None:
                self.first_dispatch_s = (time.perf_counter()
                                         - self.relaunched_at)
            return task

        return get_task


def _crash(master):
    """What a SIGKILL leaves of a master: its threads and its
    observability plane gone, its journal closed without a final
    compaction, nothing else flushed."""
    for part in (master._heartbeat, master.policy, master.aggregator):
        if part is not None:
            part.close()
    master.journal.close()
    if master._owns_obs:
        master.obs.close()


@contextlib.contextmanager
def _journal_timings():
    """Host seconds and calls of every MasterJournal append (each one
    fsynced), load (snapshot read and replay) and compaction while the
    block runs."""
    acc = {}
    cls = master_journal.MasterJournal
    saved = {name: getattr(cls, name) for name in ("record", "load",
                                                   "compact")}
    for name, inner in saved.items():
        def call(self, *args, inner=inner, name=name, **kwargs):
            start = time.perf_counter()
            try:
                return inner(self, *args, **kwargs)
            finally:
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - start
                acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1
        setattr(cls, name, call)
    try:
        yield acc
    finally:
        for name, inner in saved.items():
            setattr(cls, name, inner)


@contextlib.contextmanager
def _environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timed(obj, name, acc, key=None):
    """Wraps obj.name to add its calls and host seconds to acc[key]
    (key defaults to name)."""
    inner = getattr(obj, name)
    key = key or name

    def call(*args, **kwargs):
        start = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - start
            acc[key + "_calls"] = acc.get(key + "_calls", 0) + 1

    setattr(obj, name, call)


def _timed_batches(tds, acc):
    """Wraps tds.read_batches: acc["read_batches"] sums the host seconds
    the worker waits for each minibatch of records (the reader, its
    prefetch queue and the data-path accounting)."""
    inner = tds.read_batches

    def read_batches(*args, **kwargs):
        it = inner(*args, **kwargs)
        while True:
            start = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                acc["read_batches"] = (acc.get("read_batches", 0.0)
                                       + time.perf_counter() - start)
            yield batch

    tds.read_batches = read_batches


def _write_job_inputs(root, cfg, n_train=JOB_TRAIN_RECORDS,
                      n_valid=JOB_VALID_RECORDS, model_def=MODEL_DEF,
                      seed=0):
    """Markov-token training and validation records and a model-def file
    for an LM job (the flagship at cfg's depth); returns their paths and
    the first BATCH validation rows."""
    tokens = synthetic_lm_tokens(n_train + n_valid, SEQ, vocab=cfg.vocab,
                                 branching=4, seed=seed)
    paths = {}
    for name, rows in (("train", tokens[:n_train]),
                       ("valid", tokens[n_train:])):
        paths[name] = os.path.join(root, f"{name}.edlr")
        with RecordFileWriter(paths[name]) as writer:
            for row in rows:
                writer.write(encode_example({"tokens": row}))
    paths["model_def"] = os.path.join(root, "lm_def.py")
    with open(paths["model_def"], "w") as f:
        f.write(model_def.format(seq=SEQ, layers=cfg.n_layers))
    return paths, tokens[n_train:n_train + BATCH]


JOB_NAME = "flagship-job"
# The master is dropped after this model version: minibatch 2 of 4 of
# training task 2.
JOB_RELAUNCH_VERSION = 6


def _job_relaunch(place, common, wrap):
    """Drops the master at the place as a crash leaves it and puts a
    successor, built over the same journal and prepared, in its place.
    Returns what the drop left and the successor's set-up times."""
    first = place.master
    journal_dir = first.journal.directory
    held = [(tid, wid, task.start, task.end)
            for tid, wid, task in first.task_d.inflight_leases()]
    left = {
        "incarnation": first.master_incarnation,
        "records_done": first.task_d.stats()["records_done"],
        "held_leases": held,
        "policy_actions": first.policy.actions_total(),
        "alerts_fired": first.aggregator.alerts_fired(),
    }
    # The clock starts once the stand-in for the SIGKILL has run: closing
    # the exporter waits out its serve loop's 0.5 s poll, which a killed
    # process never pays.
    start = time.perf_counter()
    _crash(first)
    place.relaunched_at = time.perf_counter()
    left["crash_ms"] = 1e3 * (place.relaunched_at - start)
    left["wal_bytes"] = os.path.getsize(
        os.path.join(journal_dir, master_journal.WAL_NAME))
    start = time.perf_counter()
    successor = Master(_master_args(common))
    built = time.perf_counter()
    successor.prepare()
    ready = time.perf_counter()
    wrap(successor)
    place.master = successor
    # A report for the held task under another lease's token (the
    # worker's previous lease) is acknowledged and discarded: the
    # restored lease keeps the task and its accounting.
    tid = held[0][0] if held else -1
    token = successor.task_d.lease_token(tid)
    response = place.report_task_result(
        pb.ReportTaskResultRequest(task_id=tid, lease_token=token - 1), None)
    left["stale_report"] = {
        "response_empty": response == pb.Empty(),
        "lease_kept": successor.task_d.lease_token(tid) == token > 0,
        "records_done": successor.task_d.stats()["records_done"],
    }
    left.update(
        successor_build_ms=1e3 * (built - start),
        successor_prepare_ms=1e3 * (ready - built),
        drop_to_ready_ms=1e3 * (ready - place.relaunched_at),
        snapshot_bytes=os.path.getsize(
            os.path.join(journal_dir, master_journal.SNAPSHOT_NAME)))
    return left


def _events_of(obs_dir):
    with open(os.path.join(obs_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_job(direct):
    """The flagship LM trained as an elastic job through the control plane
    in this process, journaled and observed, with the master relaunched
    from its journal mid-task; then a checkpoint round trip."""
    cfg = tlm.flagship_config(SEQ)
    with tempfile.TemporaryDirectory() as root, _environ(
            ELASTICDL_MASTER_JOURNAL_DIR=os.path.join(root, "journal"),
            ELASTICDL_POLICY="1",
            ELASTICDL_HEARTBEAT_DIR=os.path.join(root, "heartbeats")), \
            _journal_timings() as jt:
        start = time.perf_counter()
        paths, eval_rows = _write_job_inputs(root, cfg)
        metrics_dir = os.path.join(root, "metrics")
        common = [
            "--model_def", paths["model_def"],
            "--distribution_strategy", "Local",
            "--training_data", paths["train"],
            "--validation_data", paths["valid"],
            "--records_per_task", str(JOB_RECORDS_PER_TASK),
            "--num_epochs", "1", "--minibatch_size", str(BATCH),
            "--evaluation_steps", str(JOB_EVAL_STEPS), "--seed", "0",
            "--job_name", JOB_NAME, "--metrics_dir", metrics_dir,
        ]
        # The master sets up this process's one observability plane over
        # its metrics dir: its exporter advertised as role "master", read
        # in process by its aggregator; the worker shares the process and
        # its registry.
        place = _MasterPlace()
        master, client, worker = _job(common, [
            "--job_type", "training_with_evaluation",
            "--log_loss_steps", str(JOB_LOG_STEPS)], place=place)
        setup_s = time.perf_counter() - start
        # Where the host's time goes: the evaluation report as the worker
        # sends it (encode, the stub's round trip, the master's handler),
        # the handler alone (decode and metric), the metric alone; the
        # task pulls and reports.
        host = {}

        def wrap(m):
            _timed(m.servicer, "report_evaluation_metrics", host,
                   "servicer_report_evaluation_metrics")
            _timed(m.evaluation_service, "report_evaluation_metrics", host,
                   "metric_update")

        wrap(master)
        for name in ("report_evaluation_metrics", "get_task",
                     "report_task_result", "report_version"):
            _timed(client, name, host, "client_" + name)
        inside = {}
        _timed(worker.trainer, "train_minibatch", inside)
        _timed(worker.trainer, "evaluate_minibatch", inside)
        step = worker.trainer.train_minibatch
        relaunch = {}

        def train_minibatch(features, labels):
            result = step(features, labels)
            if result[1] == JOB_RELAUNCH_VERSION:
                relaunch.update(_job_relaunch(place, common, wrap))
            return result

        worker.trainer.train_minibatch = train_minibatch

        fa.reset_launch_counts()
        start = time.perf_counter()
        with _logged_losses() as lines:
            try:
                worker.run()
            finally:
                criteo_transform.batch_examples = batch_examples
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = dict(fa.launches)

        successor = place.master
        # The straddling report (the lease held at the drop, reported to
        # the successor) was accepted once; a retried copy is discarded.
        held_id = relaunch["held_leases"][0][0] if relaunch else -1
        retry = pb.ReportTaskResultRequest(
            task_id=held_id,
            lease_token=int(master.task_d.lease_token(held_id))
            if relaunch else 0)
        retried = successor.servicer.report_task_result(retry, None)
        status = client.get_job_status()
        stats = successor.task_d.stats()
        evals = successor.evaluation_service.completed_results
        successor.aggregator.poll_once()
        summary = successor.aggregator.summary()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{successor.obs.metrics_port}/api/summary",
                timeout=30) as res:
            served = json.loads(res.read().decode())
        with open(os.path.join(metrics_dir, "endpoints",
                               "master.json")) as f:
            advertised = json.load(f)
        policy_actions = successor.policy.actions_total()
        alerts_fired = successor.aggregator.alerts_fired()
        wal_bytes = os.path.getsize(os.path.join(
            root, "journal", master_journal.WAL_NAME))
        successor.stop()
        events = _events_of(metrics_dir)
        with open(os.path.join(metrics_dir, "metrics.jsonl")) as f:
            metric_lines = [json.loads(line) for line in f]
        losses = [loss for _, loss, _ in lines]
        # Steady step time: between two log lines with no evaluation in
        # between (evaluation runs after the step whose version is a
        # multiple of JOB_EVAL_STEPS) and no master relaunch, tasks'
        # boundaries included.
        windows = [(b[2] - a[2]) / (b[0] - a[0])
                   for a, b in zip(lines, lines[1:])
                   if not any(v % JOB_EVAL_STEPS == 0
                              or v == JOB_RELAUNCH_VERSION
                              for v in range(a[0], b[0]))]
        step_ms = 1e3 * sum(windows) / len(windows) if windows else None
        model_s = inside.get("train_minibatch", 0.0) + inside.get(
            "evaluate_minibatch", 0.0)
        eval_batches = inside.get("evaluate_minibatch_calls", 0)
        appends = jt.get("record_calls", 0)
        kinds = [e["kind"] for e in events]
        result = {
            "phase": "job", "setup_s": setup_s, "wall_s": wall_s,
            "records_done": stats["records_done"], "steps": worker.steps,
            "tasks_recovered": stats["tasks_recovered"],
            "logged_losses": losses,
            "eval_results": evals, "eval_minibatches": eval_batches,
            "step_ms": step_ms,
            "tokens_per_s": BATCH * SEQ / (step_ms / 1e3)
            if step_ms else None,
            "train_phase_step_ms": direct["step_ms"],
            "train_phase_tokens_per_s": direct["tokens_per_s"],
            "job_over_direct_step": step_ms / direct["step_ms"]
            if step_ms else None,
            "train_minibatch_s": inside.get("train_minibatch"),
            "evaluate_minibatch_s": inside.get("evaluate_minibatch"),
            "host_share": 1.0 - model_s / wall_s,
            "host_s_by_call": host,
            "launches": launches,
        }
        emit(result)
        journal_result = {
            "phase": "job_journal",
            "journal_ops": appends,
            "ms_per_fsynced_append": 1e3 * jt.get("record", 0.0) / appends
            if appends else None,
            "replay_ms": 1e3 * jt.get("load", 0.0) / max(
                jt.get("load_calls", 0), 1),
            "replays": jt.get("load_calls", 0),
            "compaction_ms": 1e3 * jt.get("compact", 0.0) / max(
                jt.get("compact_calls", 0), 1),
            "compactions": jt.get("compact_calls", 0),
            "wal_bytes_at_drop": relaunch.get("wal_bytes"),
            "wal_bytes_at_end": wal_bytes,
            "snapshot_bytes": relaunch.get("snapshot_bytes"),
            "relaunch": {k: v for k, v in relaunch.items()
                         if k not in ("wal_bytes", "snapshot_bytes")},
            "drop_to_first_dispatch_ms": 1e3 * place.first_dispatch_s
            if place.first_dispatch_s is not None else None,
            "incarnation": status.master_incarnation,
            "events": {k: kinds.count(k) for k in sorted(set(kinds))},
            "metrics_jsonl": [(x["group"], x["step"]) for x in metric_lines],
            "aggregator_records_done": summary.get("records_done"),
            "aggregator_roles": summary.get("roles_scraped"),
            "advertised_roles": [advertised["role"]],
            "api_summary_policy": served.get("policy", {}).get(
                "actions_total"),
            "policy_actions": policy_actions,
            "alerts_fired": alerts_fired,
        }
        emit(journal_result)
        n_train = JOB_TRAIN_RECORDS // BATCH
        expected = {"flash_fwd_lse": cfg.n_layers * n_train,
                    "flash_dq": cfg.n_layers * n_train,
                    "flash_dkv": cfg.n_layers * n_train,
                    "flash_fwd": cfg.n_layers * eval_batches}
        eval_versions = [JOB_EVAL_STEPS, 2 * JOB_EVAL_STEPS]
        checks = [
            (successor.task_d.finished() and not successor.task_d.job_failed,
             "the job did not finish cleanly"),
            (stats["records_done"] == status.records_done
             == JOB_TRAIN_RECORDS, f"records_done {stats['records_done']}"),
            (worker.steps == n_train, f"{worker.steps} steps"),
            (eval_batches == 2 * JOB_VALID_RECORDS // BATCH,
             f"{eval_batches} eval minibatches"),
            (launches == expected,
             f"job launches {launches}, expected {expected}"),
            (len(losses) == n_train // JOB_LOG_STEPS
             and all(math.isfinite(x) for x in losses)
             and losses[-1] < losses[0], f"logged losses {losses}"),
            ([v for v, _ in evals] == eval_versions
             and all(math.isfinite(m["token_ce"]) for _, m in evals),
             f"evaluation results {evals}"),
            (successor is not master and relaunch.get("incarnation") == 1
             and status.master_incarnation == 2
             and successor.master_incarnation == 2,
             f"incarnation {status.master_incarnation}"),
            (len(relaunch.get("held_leases", ())) == 1
             and relaunch["records_done"] == JOB_RECORDS_PER_TASK,
             f"at the drop: {relaunch}"),
            (kinds.count("master_recovered") == 1
             and kinds.count("lease_reissued") == 1
             and kinds.count("task_stale_lease") == 1,
             f"event kinds {journal_result['events']}"),
            (relaunch.get("stale_report") == {
                "response_empty": True, "lease_kept": True,
                "records_done": JOB_RECORDS_PER_TASK},
             f"the stale-token report: {relaunch.get('stale_report')}"),
            (retried == pb.Empty(), f"the retried report: {retried}"),
            ([s for g, s in journal_result["metrics_jsonl"] if g == "eval"]
             == eval_versions, f"metrics.jsonl {journal_result}"),
            (summary.get("records_done") == JOB_TRAIN_RECORDS,
             f"aggregator records_done {summary.get('records_done')}"),
            (policy_actions == 0 and relaunch.get("policy_actions") == 0
             and "policy_decision" not in kinds,
             f"policy actions {policy_actions}"),
            (alerts_fired == 0 and relaunch.get("alerts_fired") == 0
             and "alert" not in kinds, f"alerts fired {alerts_fired}"),
        ]
        for ok, what in checks:
            if not ok:
                raise AssertionError(f"job phase: {what}")

        emit({"phase": "job", **_checkpoint_round_trip(
            worker.trainer, root, eval_rows[:, :-1],
            LocalTrainer(tlm.custom_model(tlm.flagship_config(SEQ)),
                         tlm.loss, tlm.optimizer(), seed=1))})
    return launches


def _checkpoint_round_trip(trainer, root, features, fresh):
    """save_trainer_checkpoint, then restore_on_init into `fresh`, a new
    trainer of the same model: eval outputs on one batch bitwise equal."""
    path = os.path.join(root, "ckpt.npz")
    start = time.perf_counter()
    save_trainer_checkpoint(trainer, path)
    save_s = time.perf_counter() - start
    fresh.restore_on_init = path
    start = time.perf_counter()
    fresh.init_variables_if_needed(None)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - start
    want = trainer.evaluate_minibatch(features)
    got = fresh.evaluate_minibatch(features)
    result = {"checkpoint_bytes": os.path.getsize(path), "save_s": save_s,
              "restore_s": restore_s,
              "restored_version": fresh.get_model_version(),
              "version": trainer.get_model_version(),
              "logits_bitwise_equal": bool(np.array_equal(got, want))}
    if not (result["logits_bitwise_equal"]
            and result["restored_version"] == result["version"]):
        raise AssertionError(f"checkpoint round trip: {result}")
    return result


# ---------- the Switch-MoE LM ----------


def _ancestors(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def _range_claims(events):
    """{autograd node sequence number: the MoE range (or None) of the
    forward op that created the node}. Every op records the sequence
    number the next node will take, so the last op (by start time) to
    record a number is the one that created its node."""
    claims = {}
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CPU \
                or evt.sequence_nr < 0:
            continue
        chain = list(_ancestors(evt))
        if any(a.scope == _BACKWARD_SCOPE
               or a.name.startswith(_BACKWARD_ENGINE) for a in chain):
            continue
        group = next((a.name for a in chain if a.name in MOE_RANGES), None)
        start = evt.time_range.start
        if start >= claims.get(evt.sequence_nr, (-1.0, None))[0]:
            claims[evt.sequence_nr] = (start, group)
    return {seq: group for seq, (_, group) in claims.items()}


def _op_range(evt, claims):
    """The MoE range an op runs for: its own range in the forward; in the
    backward, the range of the forward op that created its node."""
    for a in _ancestors(evt):
        if a.name in MOE_RANGES:
            return a.name
        if a.scope == _BACKWARD_SCOPE:
            return claims.get(a.sequence_nr)
    return None


def _moe_device_groups(prof):
    """Device us by group: kernels launched by an op of the MoE routing or
    expert products (forward or backward) in those groups, every other
    kernel by its name (_kernel_group; the flash kernels, launched from
    ctypes under no op, among them). The ranges' own spans are left out.
    Each kernel name's time is the device's: where its launches were
    attributed to ops for more time than that (a kernel linked to two
    ops), the shares are scaled down to it. Also the largest kernels of
    each MoE group, and the device's busy us: the union of its spans."""
    events = prof.events()
    claims = _range_claims(events)
    total, by_op, spans = {}, {}, []
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name not in MOE_RANGES:
                total[evt.name] = (total.get(evt.name, 0.0)
                                   + evt.self_device_time_total)
                spans.append((evt.time_range.start, evt.time_range.end))
            continue
        if not evt.kernels:
            continue
        group = _op_range(evt, claims)
        for kernel in evt.kernels:
            shares = by_op.setdefault(kernel.name, {})
            g = group or _kernel_group(kernel.name)
            shares[g] = shares.get(g, 0.0) + kernel.duration
    groups, largest, overlinked = {}, {}, 0.0
    for name, us in total.items():
        shares = by_op.get(name, {})
        linked = sum(shares.values())
        overlinked += max(0.0, linked - us)
        scale = min(1.0, us / linked) if linked else 0.0
        parts = {g: t * scale for g, t in shares.items()}
        if us > linked:
            g = _kernel_group(name)
            parts[g] = parts.get(g, 0.0) + us - linked
        for g, t in parts.items():
            groups[g] = groups.get(g, 0.0) + t
            if g in MOE_RANGES:
                largest.setdefault(g, []).append((t / 1e3, name[:90]))
    # Busy: the union of the device spans (kernels and copies may overlap).
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return groups, busy, {
        "largest_ms_name_by_moe_group": {
            g: sorted(v, reverse=True)[:6] for g, v in largest.items()},
        "overlinked_ms": overlinked / 1e3}


def _moe_card_vs_cpu():
    """A small float32 MoE LM through the kernels on the card against the
    same weights on the CPU: first the routing of every MoE layer (expert
    choice and keep), from each side's own layer input; then the logits,
    the loss with its aux term, and every gradient."""
    cfg = moe_lm.MoELMConfig(**MOE_CHECK_CONFIG)
    cpu = moe_lm.custom_model(cfg).to_empty(device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = moe_lm.custom_model(cfg).to_empty(device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = synthetic_lm_tokens(2, MOE_CHECK_SEQ, vocab=cfg.vocab, seed=2)
    x, y = torch.from_numpy(tokens[:, :-1]), torch.from_numpy(tokens[:, 1:])

    def run(model, device):
        inputs = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: inputs.append((mod, args[0].detach())))
            for m in model.modules() if isinstance(m, moe_layer.SwitchMoE)]
        out = model(x.to(device))
        loss = moe_lm.loss(y.to(device), out)
        loss.backward()
        for hook in hooks:
            hook.remove()
        with torch.no_grad():
            routes = [moe_layer.route(mod, inp) for mod, inp in inputs]
        return (out["logits"].detach().cpu(), out["aux_loss"].item(),
                loss.item(), routes)

    fa.reset_launch_counts()
    logits_card, aux_card, loss_card, routes_card = run(card, "cuda")
    launched = dict(fa.launches)
    logits_cpu, aux_cpu, loss_cpu, routes_cpu = run(cpu, "cpu")
    routing = []
    for i, (rc, rp) in enumerate(zip(routes_card, routes_cpu)):
        differ = (rc.expert.cpu() != rp.expert) | (rc.keep.cpu() != rp.keep)
        top2 = rp.probs.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1])
        routing.append({"layer": i, "tokens": int(rp.expert.numel()),
                        "kept": int(rp.keep.sum()),
                        "tokens_differ": int(differ.sum()),
                        "min_top2_margin": float(margins.min()),
                        "differing_top2_margins":
                            margins[differ].tolist()[:16]})
    emit({"phase": "moe_lm", "card_vs_cpu_routing": routing})
    if any(r["tokens_differ"] for r in routing):
        raise AssertionError(f"MoE routing differs card vs CPU: {routing}")
    grads_card = params_to_flax(_grads_as_params(card))
    grads_cpu = params_to_flax(_grads_as_params(cpu))
    errors = {"logits": max_err(logits_card, logits_cpu)[1],
              "loss": abs(loss_card - loss_cpu) / abs(loss_cpu),
              "aux_loss": abs(aux_card - aux_cpu) / abs(aux_cpu)}
    errors.update({n: _rel_err(grads_card[n], grads_cpu[n])
                   for n in grads_cpu})
    result = {"phase": "moe_lm", "card_vs_cpu": {
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "tolerance": MOE_CHECK_RTOL, "launches": launched,
        "max_rel_err": errors}}
    emit(result)
    bad = {k: v for k, v in errors.items() if not v <= MOE_CHECK_RTOL}
    if bad:
        raise AssertionError(f"the MoE LM on the card disagrees: {bad}")
    want = {n: cfg.n_layers for n in ("flash_fwd_lse", "flash_dq",
                                      "flash_dkv")}
    if launched != want:
        raise AssertionError(f"card_vs_cpu launches {launched}")
    return result["card_vs_cpu"]


def _moe_direct(cfg):
    """LocalTrainer on the flagship-width MoE LM: warm-up and timed steps,
    one evaluation, then a profiled step."""
    trainer = LocalTrainer(moe_lm.custom_model(cfg), moe_lm.loss,
                           moe_lm.optimizer())
    tokens = synthetic_lm_tokens(4 * BATCH, SEQ, vocab=cfg.vocab,
                                 branching=4, seed=0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses = []
    for i in range(MOE_WARMUP + MOE_STEPS):
        if i == MOE_WARMUP:
            torch.cuda.synchronize()
            start = time.perf_counter()
        rows = slice((i % 4) * BATCH, (i % 4 + 1) * BATCH)
        losses.append(trainer.train_minibatch(tokens[rows, :-1],
                                              tokens[rows, 1:])[2])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - start) / MOE_STEPS
    losses = [float(x) for x in losses]
    train_launches = dict(fa.launches)
    start = time.perf_counter()
    logits = trainer.evaluate_minibatch(tokens[:BATCH, :-1])
    eval_s = time.perf_counter() - start
    launches = dict(fa.launches)
    metric = moe_lm.eval_metrics_fn()["token_ce"]
    metric.update(logits, tokens[:BATCH, 1:])
    n_params = sum(p.numel() for p in trainer._model.parameters())
    result = {"phase": "moe_lm", "params": n_params, "batch": BATCH,
              "seq": SEQ, "num_experts": cfg.num_experts,
              "moe_every": cfg.moe_every,
              "capacity_per_expert": int(cfg.capacity_factor * BATCH * SEQ
                                         / cfg.num_experts),
              "losses": losses, "step_ms": step_ms,
              "tokens_per_s": BATCH * SEQ / (step_ms / 1e3),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "eval_ms": 1e3 * eval_s, "eval_token_ce": metric.result(),
              "train_launches": train_launches, "launches": launches}
    emit(result)
    n = MOE_WARMUP + MOE_STEPS
    expected = {"flash_fwd_lse": cfg.n_layers * n,
                "flash_dq": cfg.n_layers * n,
                "flash_dkv": cfg.n_layers * n, "flash_fwd": cfg.n_layers}
    checks = [
        (n_params == MOE_PARAMS, f"{n_params} parameters"),
        (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
         f"losses {losses}"),
        (logits.shape == (BATCH, SEQ, cfg.vocab)
         and np.isfinite(logits).all(), "eval logits"),
        (launches == expected,
         f"launches {launches}, expected {expected}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"moe_lm direct: {what}")
    result["profile"] = _profile_step(
        trainer, tokens[:BATCH, :-1], tokens[:BATCH, 1:],
        phase="moe_lm_profile", device_groups=_moe_device_groups)
    return result


def _moe_job(cfg):
    """The same model as a job through the master, then a checkpoint round
    trip."""
    with tempfile.TemporaryDirectory() as root:
        paths, eval_rows = _write_job_inputs(
            root, cfg, MOE_JOB_TRAIN, MOE_JOB_VALID, MOE_MODEL_DEF, seed=1)
        common = [
            "--model_def", paths["model_def"],
            "--distribution_strategy", "Local",
            "--training_data", paths["train"],
            "--validation_data", paths["valid"],
            "--records_per_task", str(MOE_JOB_TASK),
            "--num_epochs", "1", "--minibatch_size", str(BATCH),
            "--evaluation_steps", str(MOE_JOB_EVAL_STEPS), "--seed", "0",
        ]
        master, _, worker = _job(common, [
            "--job_type", "training_with_evaluation",
            "--log_loss_steps", str(MOE_JOB_LOG_STEPS)])
        inside = {}
        _timed(worker.trainer, "evaluate_minibatch", inside)
        fa.reset_launch_counts()
        start = time.perf_counter()
        with _logged_losses() as lines:
            worker.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = dict(fa.launches)
        stats = master.task_d.stats()
        evals = master.evaluation_service.completed_results
        losses = [loss for _, loss, _ in lines]
        eval_batches = inside.get("evaluate_minibatch_calls", 0)
        result = {"phase": "moe_lm_job", "wall_s": wall_s,
                  "records_done": stats["records_done"],
                  "steps": worker.steps, "logged_losses": losses,
                  "eval_results": evals, "eval_minibatches": eval_batches,
                  "launches": launches}
        emit(result)
        n_train = MOE_JOB_TRAIN // BATCH
        evaluated_at = list(range(MOE_JOB_EVAL_STEPS, n_train + 1,
                                  MOE_JOB_EVAL_STEPS))
        expected = {"flash_fwd_lse": cfg.n_layers * n_train,
                    "flash_dq": cfg.n_layers * n_train,
                    "flash_dkv": cfg.n_layers * n_train,
                    "flash_fwd": cfg.n_layers * eval_batches}
        checks = [
            (master.task_d.finished() and not master.task_d.job_failed,
             "the job did not finish cleanly"),
            (stats["records_done"] == MOE_JOB_TRAIN,
             f"records_done {stats['records_done']}"),
            (worker.steps == n_train, f"{worker.steps} steps"),
            (eval_batches == len(evaluated_at) * MOE_JOB_VALID // BATCH,
             f"{eval_batches} eval minibatches"),
            (launches == expected,
             f"job launches {launches}, expected {expected}"),
            (len(losses) == n_train // MOE_JOB_LOG_STEPS
             and all(math.isfinite(x) for x in losses)
             and losses[-1] < losses[0], f"logged losses {losses}"),
            ([v for v, _ in evals] == evaluated_at
             and all(math.isfinite(m["token_ce"]) for _, m in evals),
             f"evaluation results {evals}"),
        ]
        for ok, what in checks:
            if not ok:
                raise AssertionError(f"moe_lm job: {what}")
        result["checkpoint"] = _checkpoint_round_trip(
            worker.trainer, root, eval_rows[:, :-1],
            LocalTrainer(moe_lm.custom_model(cfg), moe_lm.loss,
                         moe_lm.optimizer(), seed=1))
        emit({"phase": "moe_lm_job", "checkpoint": result["checkpoint"]})
    return result


def phase_moe_lm():
    """The Switch-MoE LM: card against CPU at a small float32 config, then
    the flagship-width model direct and through the master."""
    result = {"card_vs_cpu": _moe_card_vs_cpu()}
    cfg = moe_lm.flagship_config(SEQ)
    result["direct"] = _moe_direct(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    result["job"] = _moe_job(cfg)
    return result


def _ps_batches(n, batch, seed):
    """Distinct seeded id batches, ids uniform over the shared id space (as
    the JAX package's bench/matrix.py makes them)."""
    rng = np.random.default_rng(seed)
    return [({"dense": rng.normal(size=(batch, 13)).astype(np.float32),
              "ids": rng.integers(0, TOTAL_IDS, size=(batch, NUM_FIELDS))
              .astype(np.int32)},
             rng.integers(0, 2, batch).astype(np.int64)) for _ in range(n)]


def _ps_trainer(wire, pipelined, device=None, seed=0):
    spec = deepfm_ps
    shards = [ParameterServer(i, PS_SHARDS, optimizer_spec=spec.optimizer())
              for i in range(PS_SHARDS)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype=wire)
    trainer = ParameterServerTrainer(
        spec.custom_model(), spec.loss, spec.optimizer(), client,
        embedding_inputs=spec.embedding_inputs, pipeline_pushes=pipelined,
        seed=seed, device=device)
    return trainer, client, shards


def _record_pushes(client):
    """Wraps client.push_gradients: the list it returns gets, per push, the
    dense and sparse gradients as pushed and whether all shards accepted."""
    pushes = []
    inner = client.push_gradients

    def push(dense, sparse, version, **kw):
        accepted, new_version = inner(dense, sparse, version, **kw)
        pushes.append((dense, sparse, accepted))
        return accepted, new_version

    client.push_gradients = push
    return pushes


def _count_push_bytes(client):
    """Wraps client._build_packed_requests: the dict it returns sums the
    payload bytes of every push ("bytes") and counts the pushes."""
    counts = {"bytes": 0, "pushes": 0}
    inner = client._build_packed_requests

    def build(*args, **kwargs):
        requests = inner(*args, **kwargs)
        counts["bytes"] += sum(r._nbytes for reqs in requests.values()
                               for r in reqs)
        counts["pushes"] += 1
        return requests

    client._build_packed_requests = build
    return counts


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ps_card_vs_cpu(batch):
    """One inline step at the same weights on the card and on the CPU, each
    through its own two fresh shards (which create the same rows)."""
    errors, losses = {}, {}
    cpu, cpu_client, _ = _ps_trainer("float32", False, device="cpu")
    card, card_client, _ = _ps_trainer("float32", False)
    cpu.init_variables_if_needed(batch[0])
    card.load_flax_params(params_to_flax(cpu._model))
    got = {}
    for name, trainer, client in (("cpu", cpu, cpu_client),
                                  ("card", card, card_client)):
        pushes = _record_pushes(client)
        losses[name] = float(trainer.train_minibatch(*batch)[2])
        got[name] = pushes[0]
        client.close()
    errors["loss"] = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    dense, sparse, _ = got["card"]
    cpu_dense, cpu_sparse, _ = got["cpu"]
    for name in cpu_dense:
        errors[name] = _rel_err(dense[name], cpu_dense[name])
    for table in cpu_sparse:
        errors[table + " rows"] = _rel_err(sparse[table][0],
                                           cpu_sparse[table][0])
        if not np.array_equal(sparse[table][1], cpu_sparse[table][1]):
            errors[table + " ids"] = float("inf")
    result = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
              "tolerance": PS_CHECK_RTOL, "max_rel_err": errors}
    emit({"phase": "ps_step", "card_vs_cpu": result})
    bad = {k: v for k, v in errors.items() if not v <= PS_CHECK_RTOL}
    if bad:
        raise AssertionError(f"ps_step card vs CPU: {bad}")


def _ps_profile_step(trainer, batch):
    """One inline-synchronized step under torch.profiler: the device's busy
    share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.train_minibatch(*batch)[2].item()
        trainer.flush_pushes()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    busy_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_busy_share": busy_us / 1e3 / wall_ms if busy_us
            else None}


def _ps_run(name, wire, pipelined, batches):
    trainer, client, shards = _ps_trainer(wire, pipelined)
    pushes = _record_pushes(client)
    push_bytes = _count_push_bytes(client)
    n = len(batches)

    def step(i):
        features, labels = batches[i % n]
        return trainer.train_minibatch(
            features, labels, next_features=batches[(i + 1) % n][0])[2]

    for i in range(PS_WARMUP):
        step(i)
    trainer.flush_pushes()
    torch.cuda.synchronize()
    trainer.timing.reset()
    trainer.h2d_bytes = trainer.d2h_bytes = 0
    cache0 = trainer._row_cache.stats()
    bytes0, pushes0 = push_bytes["bytes"], push_bytes["pushes"]
    start = time.perf_counter()
    losses = [step(i) for i in range(PS_WARMUP, PS_WARMUP + PS_STEPS)]
    trainer.flush_pushes()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    losses = [float(x) for x in losses]
    loss = losses[-1]
    cache1 = trainer._row_cache.stats()
    lookups = cache1["lookups"] - cache0["lookups"]
    profiled = _ps_profile_step(trainer, batches[0])
    versions = [s.parameters.version for s in shards]
    result = {
        "phase": "ps_step", "run": name, "wire": wire,
        "pipelined": pipelined, "batch": PS_BATCH, "shards": PS_SHARDS,
        "steps": PS_STEPS, "loss": loss,
        "examples_per_s": PS_STEPS * PS_BATCH / elapsed,
        "ms_per_step": 1e3 * elapsed / PS_STEPS,
        "phase_ms_per_step": {
            k: 1e3 * v["total_s"] / PS_STEPS
            for k, v in sorted(trainer.timing.summary().items())},
        "h2d_bytes_per_step": trainer.h2d_bytes / PS_STEPS,
        "d2h_bytes_per_step": trainer.d2h_bytes / PS_STEPS,
        "push_payload_bytes_per_step": (push_bytes["bytes"] - bytes0)
        / max(push_bytes["pushes"] - pushes0, 1),
        "timed_losses": losses,
        "row_cache_hit_ratio": (cache1["hits"] - cache0["hits"]) / lookups
        if lookups else None,
        "rows_per_table_per_shard": [
            {t: len(tab) for t, tab in
             s.parameters.embedding_tables.items()} for s in shards],
        "profiled_step": profiled,
        "pushes": len(pushes),
        "all_accepted": all(accepted for _, _, accepted in pushes),
        "ps_versions": versions,
    }
    emit(result)
    steps = PS_WARMUP + PS_STEPS + 1
    trainer.close()
    client.close()
    if not (result["all_accepted"] and len(pushes) == steps
            and versions == [steps] * PS_SHARDS and math.isfinite(loss)):
        raise AssertionError(
            f"ps_step {name}: {len(pushes)} pushes, all accepted "
            f"{result['all_accepted']}, versions {versions}, loss {loss}")
    return result


def phase_ps_step():
    """DeepFM-PS at batch 16384 through in-process PS shards: card against
    CPU on one batch, then the three timed runs."""
    start = time.perf_counter()
    native.lib()  # the PS host library, built with g++ at first use
    build_s = time.perf_counter() - start
    batches = _ps_batches(PS_WARMUP, PS_BATCH, seed=0)
    emit({"phase": "ps_step", "host_library_build_s": build_s,
          "host_library": native.library_path()})
    _ps_card_vs_cpu(batches[0])
    runs = {name: _ps_run(name, wire, pipelined, batches)
            for name, wire, pipelined in PS_RUNS}
    # The int8 wire against float32 on the same batches from the same
    # weights: inline (held to the bound) and pipelined (printed).
    gaps = {mode: max(abs(a - b) for a, b in zip(
        runs[f"int8_{mode}"]["timed_losses"],
        runs[f"f32_{mode}"]["timed_losses"]))
        for mode in ("inline", "pipelined")}
    emit({"phase": "ps_step", "int8_vs_f32_loss_max_abs_diff": gaps,
          "tolerance_inline": PS_INT8_LOSS_ATOL})
    if not gaps["inline"] <= PS_INT8_LOSS_ATOL:
        raise AssertionError(f"int8 vs f32 inline losses differ by {gaps}")
    return runs


def _write_ps_job_inputs(root):
    paths = {}
    for name, count, seed in (("train", PS_JOB_TRAIN, 0),
                              ("valid", PS_JOB_VALID, 1)):
        paths[name] = os.path.join(root, f"criteo_{name}.edlr")
        with RecordFileWriter(paths[name]) as writer:
            for record in iter_criteo_records(count, seed=seed):
                writer.write(record)
    return paths


def phase_ps_job():
    """DeepFM-PS trained as an elastic job through the master's tasks and
    two in-process shards, with a shard relaunched mid-job, then a PS
    checkpoint round trip."""
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        paths = _write_ps_job_inputs(root)
        write_s = time.perf_counter() - start
        common = [
            "--model_def", PS_SPEC,
            "--distribution_strategy", "ParameterServerStrategy",
            "--training_data", paths["train"],
            "--validation_data", paths["valid"],
            "--records_per_task", str(PS_JOB_TASK),
            "--num_epochs", "1", "--minibatch_size", str(PS_JOB_BATCH),
            "--evaluation_steps", str(PS_JOB_EVAL_STEPS), "--seed", "0",
        ]
        master, client, worker = _job(common, [
            "--job_type", "training_with_evaluation",
            "--log_loss_steps", "4"], num_ps=PS_SHARDS)
        trainer = worker.trainer
        host = {}
        for name in ("report_evaluation_metrics", "get_task",
                     "report_task_result", "report_version"):
            _timed(client, name, host, "client_" + name)
        _timed(master.servicer, "report_evaluation_metrics", host,
               "servicer_report_evaluation_metrics")
        fed = {"records": 0}
        inner_feed = worker._spec.feed

        def feed(records, mode, metadata):
            fed["records"] += len(records)
            return inner_feed(records, mode, metadata)

        worker._spec.feed = feed
        _timed(worker._spec, "feed", host, "feed")
        # The decode alone, inside the feed (the transform is the rest).
        _timed(criteo_transform, "batch_examples", host, "decode")
        _timed_batches(worker._tds, host)
        inside = {}
        _timed(trainer, "train_minibatch", inside)
        _timed(trainer, "evaluate_minibatch", inside)
        pushes = _record_pushes(trainer._ps)
        timed_train = trainer.train_minibatch
        drill = {}

        def train(features, labels):
            if inside.get("train_minibatch_calls", 0) == PS_RESEED_AFTER:
                # Between steps 8 and 9 shard 0 comes back empty, as a
                # relaunched PS pod on the same address.
                trainer.flush_pushes()
                drill["version_before"] = trainer.get_model_version()
                fresh = master.relaunch_ps(0)
                drill["fresh_initialized"] = fresh.parameters.initialized
            return timed_train(features, labels)

        trainer.train_minibatch = train
        fa.reset_launch_counts()
        start = time.perf_counter()
        with _logged_losses() as lines:
            worker.run()
            trainer.close()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        launches = dict(fa.launches)

        stats = master.task_d.stats()
        evals = master.evaluation_service.completed_results
        losses = [loss for _, loss, _ in lines]
        versions = [s.parameters.version for s in master.ps_servers]
        model_s = inside.get("train_minibatch", 0.0) + inside.get(
            "evaluate_minibatch", 0.0)
        n_steps = PS_JOB_TRAIN // PS_JOB_BATCH
        drill["fresh_shard_initialized_after"] = (
            master.ps_servers[0].parameters.initialized)
        result = {
            "phase": "ps_job", "write_records_s": write_s, "wall_s": wall_s,
            "minibatch": PS_JOB_BATCH,
            "records_done": stats["records_done"], "steps": worker.steps,
            "pushes": len(pushes),
            "pushes_accepted": sum(a for _, _, a in pushes),
            "ps_versions": versions, "reseed_drill": drill,
            "logged_losses": losses, "eval_results": evals,
            "train_minibatch_s": inside.get("train_minibatch"),
            "evaluate_minibatch_s": inside.get("evaluate_minibatch"),
            "host_share": 1.0 - model_s / wall_s,
            "host_s_by_call": host,
            "records_decoded": fed["records"],
            "feed_ms_per_record": 1e3 * host.get("feed", 0.0)
            / max(fed["records"], 1),
            "decode_ms_per_record": 1e3 * host.get("decode", 0.0)
            / max(fed["records"], 1),
            "launches": launches,
        }
        emit(result)
        checks = [
            (master.task_d.finished() and not master.task_d.job_failed,
             "the job did not finish cleanly"),
            (stats["records_done"] == PS_JOB_TRAIN,
             f"records_done {stats['records_done']}"),
            (worker.steps == n_steps, f"{worker.steps} steps"),
            (len(pushes) == n_steps and all(a for _, _, a in pushes),
             f"{len(pushes)} pushes, accepted {result['pushes_accepted']}"),
            (versions == [n_steps] * PS_SHARDS, f"PS versions {versions}"),
            (drill.get("fresh_initialized") is False
             and drill["fresh_shard_initialized_after"],
             f"re-seed drill {drill}"),
            (evals and all({"auc", "accuracy"} <= set(m)
                           and all(math.isfinite(x) for x in m.values())
                           for _, m in evals),
             f"evaluation results {evals}"),
            (len(losses) >= 2 and all(math.isfinite(x) for x in losses)
             and losses[-1] < losses[0], f"logged losses {losses}"),
            (not any(launches.values()), f"launches {launches}"),
        ]
        for ok, what in checks:
            if not ok:
                raise AssertionError(f"ps_job phase: {what}")
        emit({"phase": "ps_job", **_ps_checkpoint_round_trip(
            master, trainer, root)})
    return result


def _ps_checkpoint_round_trip(master, trainer, root):
    """Every shard saved at the last version, restored into fresh shards:
    a fresh worker's eval outputs bitwise equal to the job's worker's."""
    features, _ = deepfm_ps.feed(
        list(iter_criteo_records(PS_JOB_BATCH, seed=1)), "evaluation", None)
    # First, so that rows the evaluation creates are in the checkpoint.
    want = trainer.evaluate_minibatch(features)
    ckpt_dir = os.path.join(root, "ps_ckpt")
    version = master.ps_servers[0].parameters.version
    start = time.perf_counter()
    for i, server in enumerate(master.ps_servers):
        ps_checkpoint.CheckpointSaver(ckpt_dir, i, PS_SHARDS).save(
            version, server.parameters)
    save_s = time.perf_counter() - start
    vdir = os.path.join(ckpt_dir, f"version-{version}")
    nbytes = sum(os.path.getsize(os.path.join(vdir, f))
                 for f in os.listdir(vdir))
    start = time.perf_counter()
    fresh = [ParameterServer(i, PS_SHARDS,
                             optimizer_spec=deepfm_ps.optimizer(),
                             checkpoint_dir_for_init=ckpt_dir)
             for i in range(PS_SHARDS)]
    restore_s = time.perf_counter() - start
    client = PSClient([s.stub() for s in fresh], worker_id=1)
    restored = ParameterServerTrainer(
        deepfm_ps.custom_model(), deepfm_ps.loss, deepfm_ps.optimizer(),
        client, embedding_inputs=deepfm_ps.embedding_inputs, seed=1)
    got = restored.evaluate_minibatch(features)
    client.close()
    result = {"checkpoint_bytes": nbytes, "save_s": save_s,
              "restore_s": restore_s, "version": version,
              "restored_version": restored.get_model_version(),
              "rows_per_table": {
                  t: sum(len(s.parameters.embedding_tables[t])
                         for s in fresh)
                  for t in fresh[0].parameters.embedding_tables},
              "eval_outputs_bitwise_equal": bool(np.array_equal(got, want))}
    if not (result["eval_outputs_bitwise_equal"]
            and result["restored_version"] == version):
        raise AssertionError(f"PS checkpoint round trip: {result}")
    return result


# ---------- the CTR family on the card ----------


def _ctr_batches():
    """Two batches of CTR_BATCH Criteo records, each fed (decoded and
    transformed on the host) by the dac_ctr feed and by WDL's, which keeps
    the raw ids for the model to hash; and each feed's ms per record."""
    records = [list(iter_criteo_records(CTR_BATCH, seed=seed))
               for seed in (10, 11)]
    batches, feed_ms = {}, {}
    for name, feed in (("dac_ctr", criteo_transform.feed),
                       ("wdl", wdl.feed)):
        start = time.perf_counter()
        batches[name] = [feed(r, "training", None) for r in records]
        feed_ms[name] = 1e3 * (time.perf_counter() - start) / (
            len(records) * CTR_BATCH)
    return batches, feed_ms


def _ctr_card_vs_cpu(module, batch):
    """One batch through the same weights on the card and on the CPU:
    loss and every gradient."""
    features, labels = batch
    cpu = module.custom_model().to_empty(device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = module.custom_model().to_empty(device="cuda")
    card.load_state_dict(cpu.state_dict())
    got = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        logits = model({k: torch.as_tensor(v).to(device)
                        for k, v in features.items()})
        loss = module.loss(labels, logits)
        loss.backward()
        got[name] = (loss.item(), {
            leaf.name: leaf.to_flax(leaf.param.grad).cpu().numpy()
            for leaf in flax_leaves(model)})
    (loss_card, grads_card), (loss_cpu, grads_cpu) = got["card"], got["cpu"]
    errors = {"loss": abs(loss_card - loss_cpu) / abs(loss_cpu)}
    for name in grads_cpu:
        errors[name] = _rel_err(grads_card[name], grads_cpu[name])
    return {"loss_card": loss_card, "loss_cpu": loss_cpu,
            "tolerance": CTR_CHECK_RTOL, "max_rel_err": errors}


def _ctr_run(name, module, batches):
    torch.cuda.reset_peak_memory_stats()
    trainer = LocalTrainer(module.custom_model(), module.loss,
                           module.optimizer())
    for i in range(CTR_WARMUP):
        trainer.train_minibatch(*batches[i % len(batches)])
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = [trainer.train_minibatch(*batches[i % len(batches)])[2]
              for i in range(CTR_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    losses = [float(x) for x in losses]
    profile = _profile_step(trainer, *batches[0], phase=f"ctr_zoo_{name}")
    result = {
        "phase": "ctr_zoo", "model": name, "batch": CTR_BATCH,
        # Rows per table: the shared id space, or WDL's hash buckets.
        "vocab": (wdl.NUM_SPARSE * wdl.HASH_BUCKETS if module is wdl
                  else TOTAL_IDS),
        "params": sum(p.numel() for p in trainer._model.parameters()),
        "steps": CTR_STEPS, "ms_per_step": 1e3 * elapsed / CTR_STEPS,
        "examples_per_s": CTR_STEPS * CTR_BATCH / elapsed,
        "timed_losses": losses,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device_busy_share": profile["device_busy_share"],
        "card_vs_cpu": _ctr_card_vs_cpu(module, batches[0]),
    }
    emit(result)
    bad = {k: v for k, v in result["card_vs_cpu"]["max_rel_err"].items()
           if not v <= CTR_CHECK_RTOL}
    if bad or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ctr_zoo {name}: {bad}, losses {losses}")
    return result


def phase_ctr_zoo():
    """DeepFM, wide & deep, DCN and xDeepFM with device-resident tables at
    full width, and deepctr's WDL (26 hashed feature columns), on
    LocalTrainer: ms per step, and card against CPU on one batch. None
    launches a flash-attention kernel."""
    batches, feed_ms = _ctr_batches()
    emit({"phase": "ctr_zoo", "feed_ms_per_record": feed_ms["dac_ctr"],
          "wdl_feed_ms_per_record": feed_ms["wdl"], "batch": CTR_BATCH})
    fa.reset_launch_counts()
    results = {}
    for name, module in CTR_HEADS:
        results[name] = _ctr_run(
            name, module, batches["wdl" if name == "wdl" else "dac_ctr"])
        torch.cuda.empty_cache()
    launches = dict(fa.launches)
    emit({"phase": "ctr_zoo", "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"ctr_zoo launches {launches}")
    return results


# ---------- the flagship LM on the parameter server ----------


def _write_lm_ps_inputs(root, cfg):
    tokens = synthetic_lm_tokens(LM_PS_STEPS * BATCH, SEQ, vocab=cfg.vocab,
                                 branching=4, seed=2)
    paths = {"train": os.path.join(root, "lm_ps_train.edlr"),
             "model_def": os.path.join(root, "flagship_lm_ps.py")}
    with RecordFileWriter(paths["train"]) as writer:
        for row in tokens:
            writer.write(encode_example({"tokens": row}))
    with open(paths["model_def"], "w") as f:
        f.write(MODEL_DEF.format(seq=SEQ, layers=cfg.n_layers))
    return paths, tokens


def _lm_ps_worker(paths, wire):
    common = [
        "--model_def", paths["model_def"],
        "--distribution_strategy", "ParameterServerStrategy",
        "--training_data", paths["train"],
        "--records_per_task", str(LM_PS_TASK), "--num_epochs", "1",
        "--minibatch_size", str(BATCH), "--seed", "0",
    ]
    master, _, worker = _job(common, [
        "--job_type", "training_only", "--log_loss_steps", "1",
        "--ps_wire_dtype", wire], num_ps=PS_SHARDS)
    return master, worker


def _job_phase_seconds(timing):
    """The worker resets its trainer's Timing after each task: the dict
    this returns keeps the seconds per phase over the whole job (read it
    with the last summary added, see _lm_ps_job)."""
    total = {}
    inner = timing.report

    def report(logger, reset=False):
        if reset:
            for phase, s in timing.summary().items():
                total[phase] = total.get(phase, 0.0) + s["total_s"]
        return inner(logger, reset=reset)

    timing.report = report
    return total


def _capture_first_step(trainer):
    """Wraps trainer._ps_step: the dict it returns gets the first step's
    batch, the weights and rows it ran on, its loss and row gradients."""
    first = {}
    inner = trainer._ps_step

    def ps_step(features, labels, rows):
        if not first:
            first["dense"] = params_to_flax(trainer._model)
            first["rows"] = {t: r.detach().float().cpu().numpy()
                             for t, r in rows.items()}
        loss, dense_grads, row_grads = inner(features, labels, rows)
        if "loss" not in first:
            first.update(
                features=features.cpu().numpy(), labels=labels.cpu().numpy(),
                loss=float(loss),
                row_grads={t: g.float().cpu().numpy()
                           for t, g in row_grads.items()})
        return loss, dense_grads, row_grads

    trainer._ps_step = ps_step
    return first


def _lm_ps_against_local(cfg, first):
    """(c): the first batch through a direct LocalTrainer step from the
    same weights, its tables holding the PS rows the PS step read (float32
    rows, as under the PS)."""
    named = dict(first["dense"])
    tokens = first["features"]
    # The feed's ids: the tokens, and the positions arange(S) (pos_emb's
    # rows and row gradients are [S, d], summed over the batch).
    ids = {"tok_emb": tokens.reshape(-1), "pos_emb": np.arange(SEQ)}
    for table, num in (("tok_emb", cfg.vocab), ("pos_emb", cfg.max_len)):
        full = np.zeros((num, cfg.d_model), np.float32)
        full[ids[table]] = first["rows"][table]
        named[f"{table}/embedding"] = full
    trainer = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer())
    trainer.load_flax_params(named)
    model = trainer._model
    model.tok_emb.compute_dtype = model.pos_emb.compute_dtype = torch.float32
    loss = trainer.train_minibatch(tokens, first["labels"])[2].item()
    errors = {"loss": abs(loss - first["loss"]) / abs(loss)}
    for table in ("tok_emb", "pos_emb"):
        values, unique = tensor_utils.deduplicate_indexed_slices(
            first["row_grads"][table], ids[table])
        local = getattr(model, table).weight.grad[
            torch.as_tensor(unique, device="cuda")].cpu().numpy()
        errors[f"{table} rows"] = _rel_err(values, local)
    result = {"loss_ps": first["loss"], "loss_local": loss,
              "tolerance": {"loss": LM_PS_LOSS_RTOL,
                            "row_grads": LM_PS_GRAD_RTOL},
              "max_rel_err": errors}
    ok = errors["loss"] <= LM_PS_LOSS_RTOL and all(
        v <= LM_PS_GRAD_RTOL for k, v in errors.items() if k != "loss")
    return result, ok


def _lm_ps_export_check(cfg, trainer, tokens):
    """(d): the export loads into a stock TransformerLM whose logits equal
    the PS trainer's forward bitwise (the same float32 gathers). Under the
    int8 wire the trainer's rows cross it as bfloat16, so the stock tables
    are the exported ones rounded to bfloat16."""
    batch = tokens[:1, :-1]
    want = trainer.evaluate_minibatch(batch)
    exported = trainer.export_variables()["variables"]
    stock = tlm.custom_model(cfg).to_empty(device="cuda")
    loaded = dict(exported)
    if trainer._bf16_wire:
        for table in trainer._embedding_vocab:
            name = f"{table}/embedding"
            loaded[name] = tensor_utils.bfloat16_bits_to_float32(
                tensor_utils.float32_to_bfloat16_bits(exported[name]))
    stock.load_state_dict(params_from_flax(loaded, stock))
    stock.tok_emb.compute_dtype = stock.pos_emb.compute_dtype = torch.float32
    stock.eval()
    with torch.no_grad():
        got = stock(torch.as_tensor(batch, device="cuda")).cpu().numpy()
    return {"export_tables": {k: list(v.shape) for k, v in exported.items()
                              if k.endswith("/embedding")},
            "export_logits_bitwise_equal": bool(np.array_equal(got, want))}


def _lm_ps_job(cfg, paths, tokens, wire):
    master, worker = _lm_ps_worker(paths, wire)
    trainer = worker.trainer
    first = _capture_first_step(trainer)
    phase_s = _job_phase_seconds(trainer.timing)
    push_bytes = _count_push_bytes(trainer._ps)
    accepted = []
    inner_push = trainer._ps.push_gradients

    def push(*args, **kwargs):
        result = inner_push(*args, **kwargs)
        accepted.append(result[0])
        return result

    trainer._ps.push_gradients = push
    fa.reset_launch_counts()
    start = time.perf_counter()
    with _logged_losses() as lines:
        worker.run()
        trainer.close()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = dict(fa.launches)
    stats = master.task_d.stats()
    losses = [loss for _, loss, _ in lines]
    versions = [s.parameters.version for s in master.ps_servers]
    for phase, summary in trainer.timing.summary().items():
        # What ran after the last task's report (the last push).
        phase_s[phase] = phase_s.get(phase, 0.0) + summary["total_s"]
    steps = worker.steps
    moved = {t: {"vocab": v, "bytes": v * trainer._embedding_dims[t] * 4}
             for t, v in sorted(trainer._embedding_vocab.items())}
    result = {
        "phase": "lm_ps", "wire": wire, "batch": BATCH, "seq": SEQ,
        "shards": PS_SHARDS, "tables_moved": moved,
        "dense_params": sum(p.numel() for p in trainer._model.parameters()),
        "feed_derived": not hasattr(worker._spec.module, "embedding_inputs")
        and trainer._embedding_inputs is not None,
        "records_done": stats["records_done"], "steps": steps,
        "losses": losses, "wall_s": wall_s,
        "ms_per_step": 1e3 * wall_s / max(steps, 1),
        "phase_ms_per_step": {k: 1e3 * v / max(steps, 1)
                              for k, v in sorted(phase_s.items())},
        "push_payload_bytes_per_push": push_bytes["bytes"]
        / max(push_bytes["pushes"], 1),
        "pushes": len(accepted), "all_accepted": all(accepted),
        "ps_versions": versions, "launches": launches,
    }
    n = LM_PS_STEPS * cfg.n_layers
    expected = {"flash_fwd_lse": n, "flash_dq": n, "flash_dkv": n,
                # the capture forward that derives the feed, at init
                "flash_fwd": cfg.n_layers}
    checks = [
        (set(moved) == {"tok_emb", "pos_emb"} and result["feed_derived"],
         f"tables moved {moved}, feed derived {result['feed_derived']}"),
        (stats["records_done"] == LM_PS_STEPS * BATCH
         and steps == LM_PS_STEPS, f"records_done {stats['records_done']}, "
         f"steps {steps}"),
        (len(accepted) == steps and all(accepted)
         and versions == [steps] * PS_SHARDS,
         f"pushes {accepted}, PS versions {versions}"),
        (len(losses) == steps and all(math.isfinite(x) for x in losses)
         and losses[-1] < losses[0], f"losses {losses}"),
        (launches == expected, f"launches {launches}, expected {expected}"),
    ]
    result.update(_lm_ps_export_check(cfg, trainer, tokens))
    checks.append((result["export_logits_bitwise_equal"],
                   "exported stock model's logits differ"))
    # One more step under the profiler, after the counts were read.
    result["profiled_step"] = _ps_profile_step(
        trainer, (tokens[:BATCH, :-1], tokens[:BATCH, 1:]))
    trainer.close()
    if wire == "float32":
        del worker, trainer
        torch.cuda.empty_cache()
        result["against_local_trainer"], ok = _lm_ps_against_local(cfg,
                                                                   first)
        checks.append((ok, f"first step against LocalTrainer "
                           f"{result['against_local_trainer']}"))
    emit(result)
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"lm_ps {wire}: {what}")
    return result


def phase_lm_ps():
    """The flagship LM (full width, PROC_LAYERS layers) on
    ParameterServerStrategy through the master, its tables moved to the
    PS automatically: a job on the float32 wire and one on the int8
    wire."""
    cfg = proc_config()
    with tempfile.TemporaryDirectory() as root:
        paths, tokens = _write_lm_ps_inputs(root, cfg)
        results = {wire: _lm_ps_job(cfg, paths, tokens, wire)
                   for wire in LM_PS_WIRES}
    emit({"phase": "lm_ps", "peak_rss_gib":
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20})
    return results


# ---------- the image and tabular zoo ----------


def _zoo_images(n, seed, shape=(ZOO_IMAGE, ZOO_IMAGE, 3)):
    """n float32 NHWC images: one of ZOO_CLASSES fixed templates plus
    noise, so a classifier's loss falls within a few steps; int64
    labels."""
    templates = np.random.default_rng(0).standard_normal(
        (ZOO_CLASSES, *shape), dtype=np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, ZOO_CLASSES, n)
    images = templates[labels]
    images += 0.5 * rng.standard_normal(images.shape, dtype=np.float32)
    return images, labels.astype(np.int64)


def _zoo_kernel_group(name):
    low = name.lower()
    for group, keys in (
            ("conv", ("conv", "cudnn", "xmma", "implicit", "fprop",
                      "dgrad", "wgrad", "winograd", "nhwc", "cutlass",
                      "sm90_")),
            ("gemm", ("gemm", "nvjet")),
            ("optimizer", ("multi_tensor",)),
            ("reduce: BatchNorm statistics, spatial mean", ("reduce",)),
            ("max_pool", ("pool",)),
            ("elementwise: BatchNorm normalize, relu, casts, pads",
             ("elementwise", "copy", "fill", "pad", "cat"))):
        if any(key in low for key in keys):
            return group
    return "other"


def _zoo_forward_flops(model, image):
    """Model FLOPs of one image's forward from the conv and dense shapes
    (2 per multiply-add), counted by forward hooks on an eval forward
    (which updates no BatchNorm statistics)."""
    total = [0]

    def hook(module, inputs, out):
        if isinstance(module, Conv):
            total[0] += 2 * out.numel() * module.weight[0].numel()
        elif isinstance(module, torch.nn.Linear):
            total[0] += 2 * out.numel() * module.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, torch.nn.Linear))]
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.as_tensor(image).cuda())
    finally:
        model.train(training)
        for handle in handles:
            handle.remove()
    return total[0]


def _zoo_direct(name, module, batch):
    """LocalTrainer at full width, batch `batch` of 224x224 images:
    ZOO_WARMUP then ZOO_STEPS timed steps, the step's model FLOPs against
    the bf16 data-sheet peak, one profiled step."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = LocalTrainer(module.custom_model(), module.loss,
                           module.optimizer())
    batches = [_zoo_images(batch, seed) for seed in (20, 21)]
    losses = [float(trainer.train_minibatch(*batches[i % 2])[2])
              for i in range(ZOO_WARMUP)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    timed = [trainer.train_minibatch(*batches[i % 2])[2]
             for i in range(ZOO_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    losses += [float(x) for x in timed]
    step_ms = 1e3 * elapsed / ZOO_STEPS
    flops = 3 * batch * _zoo_forward_flops(trainer._model,
                                           batches[0][0][:1])
    result = {
        "phase": "zoo", "model": name, "batch": batch,
        "image": ZOO_IMAGE, "dtype": "bfloat16 convs, float32 BatchNorm",
        "params": sum(p.numel() for p in trainer._model.parameters()),
        "steps": ZOO_STEPS, "ms_per_step": step_ms,
        "img_per_s": batch * ZOO_STEPS / elapsed,
        "losses": losses,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "step_flops": flops,
        "flops_share_of_bf16_peak": flops / (step_ms / 1e3)
        / PEAK_BF16_FLOPS,
    }
    emit(result)
    if not (all(math.isfinite(x) for x in losses)
            and np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"zoo {name}: losses {losses}")
    result["profile"] = _profile_step(trainer, *batches[0],
                                      classify=_zoo_kernel_group,
                                      phase=f"zoo_profile_{name}")
    return trainer, result


def _zoo_job(root):
    """ResNet-50 trained as a job through the master on .edlr records of
    float32 images, then a checkpoint round trip."""
    start = time.perf_counter()
    paths = {"train": os.path.join(root, "zoo_train.edlr"),
             "valid": os.path.join(root, "zoo_valid.edlr")}
    chunk = ZOO_JOB_BATCH
    for name, n, seed in (("train", ZOO_JOB_TRAIN, 30),
                          ("valid", ZOO_JOB_VALID, 60)):
        with RecordFileWriter(paths[name]) as writer:
            for k in range(n // chunk):
                images, labels = _zoo_images(chunk, seed + k)
                for image, label in zip(images, labels):
                    writer.write(encode_example(
                        {"image": image, "label": label}))
    write_s = time.perf_counter() - start
    common = [
        "--model_def", "elasticdl_tpu_torch.models.resnet50.resnet50",
        "--distribution_strategy", "Local",
        "--training_data", paths["train"],
        "--validation_data", paths["valid"],
        "--records_per_task", str(ZOO_JOB_TASK), "--num_epochs", "1",
        "--minibatch_size", str(ZOO_JOB_BATCH),
        "--evaluation_steps", str(ZOO_JOB_EVAL_STEPS), "--seed", "0",
    ]
    master, _, worker = _job(common, [
        "--job_type", "training_with_evaluation", "--log_loss_steps", "1"])
    start = time.perf_counter()
    with _logged_losses() as lines:
        worker.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    stats = master.task_d.stats()
    evals = master.evaluation_service.completed_results
    losses = [loss for _, loss, _ in lines]
    n_steps = ZOO_JOB_TRAIN // ZOO_JOB_BATCH
    result = {"phase": "zoo_job", "model": "resnet50",
              "records_write_s": write_s, "wall_s": wall_s,
              "records_done": stats["records_done"], "steps": worker.steps,
              "logged_losses": losses, "eval_results": evals}
    emit(result)
    checks = [
        (master.task_d.finished() and not master.task_d.job_failed,
         "the job did not finish cleanly"),
        (stats["records_done"] == ZOO_JOB_TRAIN,
         f"records_done {stats['records_done']}"),
        (worker.steps == n_steps, f"{worker.steps} steps"),
        (len(losses) == n_steps and all(math.isfinite(x) for x in losses),
         f"logged losses {losses}"),
        ([v for v, _ in evals] == list(range(
            ZOO_JOB_EVAL_STEPS, n_steps + 1, ZOO_JOB_EVAL_STEPS))
         and all(math.isfinite(m["accuracy"]) for _, m in evals),
         f"evaluation results {evals}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"zoo_job: {what}")
    features, _ = _zoo_images(ZOO_JOB_BATCH, 60)
    fresh = LocalTrainer(resnet50.custom_model(), resnet50.loss,
                         resnet50.optimizer(), seed=1)
    round_trip = _checkpoint_round_trip(worker.trainer, root, features,
                                        fresh)
    emit({"phase": "zoo_job", **round_trip})
    return dict(result, checkpoint=round_trip)


def _zoo_ps():
    """ResNet-50 at 224x224 on ParameterServerTrainer with 2 in-process
    shards (f32 wire, momentum on the PS), its BatchNorm statistics kept
    and updated on the worker: the first batch against a direct
    LocalTrainer step from the same weights and buffers, both with cudnn's
    deterministic algorithms; then warm-up and timed steps."""
    torch.cuda.empty_cache()
    shards = [ParameterServer(i, ZOO_PS_SHARDS,
                              optimizer_spec=resnet50.optimizer())
              for i in range(ZOO_PS_SHARDS)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype="float32")
    trainer = ParameterServerTrainer(resnet50.custom_model(), resnet50.loss,
                                     resnet50.optimizer(), client)
    pushes = _record_pushes(client)
    push_bytes = _count_push_bytes(client)
    batches = [_zoo_images(ZOO_PS_BATCH, seed) for seed in (30, 31)]
    trainer.init_variables_if_needed(batches[0][0])
    named = {k: np.array(v) for k, v in
             params_to_flax(trainer._model).items()}
    stats0 = state_to_flax(trainer._model)

    # The first batch, deterministic on both sides.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss = float(trainer.train_minibatch(*batches[0])[2])
        trainer.flush_pushes()
        stats1 = state_to_flax(trainer._model)
        local = LocalTrainer(resnet50.custom_model(), resnet50.loss,
                             resnet50.optimizer())
        local.load_flax_params(named, stats0)
        local_loss = float(local.train_minibatch(*batches[0])[2])
        local_grads = {leaf.name: leaf.to_flax(leaf.param.grad).cpu()
                       .numpy() for leaf in flax_leaves(local._model)}
        local_stats = state_to_flax(local._model)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del local
    torch.cuda.empty_cache()
    dense = pushes[0][0]
    scale = max(float(np.abs(g).max()) for g in local_grads.values())
    grad_err = max(float(np.abs(np.asarray(dense[name], np.float64)
                                - local_grads[name]).max())
                   for name in local_grads) / scale
    worst_tensor = max(_rel_err(dense[name], local_grads[name])
                       for name in local_grads)
    stats_err = max(_rel_err(stats1[k], local_stats[k]) for k in stats1)
    loss_err = abs(loss - local_loss) / abs(local_loss)
    moved = max(float(np.abs(stats1[k] - stats0[k]).max()) for k in stats1)

    for i in range(ZOO_PS_WARMUP - 1):
        trainer.train_minibatch(*batches[(i + 1) % 2])
    trainer.flush_pushes()
    torch.cuda.synchronize()
    trainer.timing.reset()
    bytes0, pushes0 = push_bytes["bytes"], push_bytes["pushes"]
    start = time.perf_counter()
    losses = [trainer.train_minibatch(*batches[i % 2])[2]
              for i in range(ZOO_PS_STEPS)]
    trainer.flush_pushes()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    losses = [float(x) for x in losses]
    profiled = _ps_profile_step(trainer, batches[0])
    stats_end = state_to_flax(trainer._model)
    versions = [s.parameters.version for s in shards]
    steps = ZOO_PS_WARMUP + ZOO_PS_STEPS + 1
    result = {
        "phase": "zoo_ps", "model": "resnet50", "batch": ZOO_PS_BATCH,
        "image": ZOO_IMAGE, "shards": ZOO_PS_SHARDS, "wire": "float32",
        "dense_params": sum(p.numel() for p in trainer._model.parameters()),
        "batch_stats_tensors": len(stats_end),
        "first_batch": {"loss": loss, "local_loss": local_loss,
                        "loss_rel_err": loss_err,
                        "grad_err_of_largest": grad_err,
                        "worst_tensor_rel_err": worst_tensor,
                        "batch_stats_rel_err": stats_err,
                        "batch_stats_max_move": moved},
        "steps": ZOO_PS_STEPS, "ms_per_step": 1e3 * elapsed / ZOO_PS_STEPS,
        "img_per_s": ZOO_PS_BATCH * ZOO_PS_STEPS / elapsed,
        "phase_ms_per_step": {
            k: 1e3 * v["total_s"] / ZOO_PS_STEPS
            for k, v in sorted(trainer.timing.summary().items())},
        "push_payload_bytes_per_step": (push_bytes["bytes"] - bytes0)
        / max(push_bytes["pushes"] - pushes0, 1),
        "timed_losses": losses,
        "profiled_step": profiled,
        "pushes": len(pushes),
        "all_accepted": all(accepted for _, _, accepted in pushes),
        "ps_versions": versions,
    }
    emit(result)
    trainer.close()
    client.close()
    checks = [
        (loss_err <= ZOO_PS_LOSS_RTOL, f"first loss {loss} vs {local_loss}"),
        (grad_err <= ZOO_PS_GRAD_RTOL, f"first gradients {grad_err}"),
        (stats_err <= ZOO_PS_STATS_RTOL, f"first batch_stats {stats_err}"),
        (moved > 0 and any(not np.array_equal(stats_end[k], stats1[k])
                           for k in stats1), "batch_stats did not move"),
        (result["all_accepted"] and len(pushes) == steps
         and versions == [steps] * ZOO_PS_SHARDS,
         f"{len(pushes)} pushes, versions {versions}"),
        (all(math.isfinite(x) for x in losses), f"losses {losses}"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"zoo_ps: {what}")
    return result


def _zoo_check_models(cls):
    """The float32 model on the CPU and on the card, and a float64 copy on
    the CPU, with the same weights: flax's initializers, then every
    BatchNorm's scale, bias and running statistics moved off their initial
    values."""
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        cpu, card = cls(dtype="float32"), cls(dtype="float32")
        exact = cls(dtype="float64")
    cpu.to_empty(device="cpu")
    cpu.init_weights(gen)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
                mod.mean.normal_(0.0, 0.1, generator=gen)
                mod.var.uniform_(0.5, 1.5, generator=gen)
    initial = copy.deepcopy(cpu.state_dict())
    card.to_empty(device="cuda")
    card.load_state_dict(initial)
    exact.to_empty(device="cpu")
    exact.double().load_state_dict(initial)
    return cpu, card, exact


class _ModuleRecorder:
    """For every Conv, BatchNorm and Linear of a model: its buffers before
    and after the forward, its input and output, and the gradients at its
    output and input, copied to the CPU as they pass."""

    KINDS = (Conv, BatchNorm, torch.nn.Linear)

    def __init__(self, model):
        self.records = {}
        self._handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, self.KINDS):
                rec = self.records[name] = {}
                self._handles += [
                    mod.register_forward_pre_hook(
                        lambda m, args, rec=rec: rec.update(
                            state=self._buffers(m))),
                    mod.register_forward_hook(
                        lambda m, args, out, rec=rec: rec.update(
                            input=args[0].detach().cpu(),
                            output=out.detach().cpu(),
                            new_state=self._buffers(m))),
                    mod.register_full_backward_hook(
                        lambda m, gin, gout, rec=rec: rec.update(
                            grad_output=gout[0].cpu(),
                            grad_input=None if gin[0] is None
                            else gin[0].cpu())),
                ]

    @staticmethod
    def _buffers(mod):
        return {k: v.detach().cpu().clone()
                for k, v in mod.named_buffers()}

    def close(self):
        for handle in self._handles:
            handle.remove()


def _zoo_step(model, images, labels, training):
    """One forward and backward of the loss: {logits, loss, the new
    batch_stats}, and {leaf: flax-layout gradient}, as float64 numpy."""
    device = next(model.parameters()).device
    model.train(training)
    model.zero_grad(set_to_none=True)
    with warnings.catch_warnings():
        # The stem's input needs no gradient; its hook still fires.
        warnings.filterwarnings("ignore", "Full backward hook")
        logits = model(torch.as_tensor(images).to(device))
        loss = resnet50.loss(labels, logits)
        loss.backward()
    values = {"logits": logits.detach().double().cpu().numpy(),
              "loss": np.asarray(loss.item()), **state_to_flax(model)}
    grads = {leaf.name: leaf.to_flax(leaf.param.grad).double().cpu().numpy()
             for leaf in flax_leaves(model)}
    return values, grads


def _module_errors(reference, records, grads, training):
    """Each recorded module of the card's model run alone on `reference`'s
    counterpart from the card's own input, buffers and output gradient:
    {"<module>:<what>": error}. The output, the input gradient and the new
    buffers are shares of their own largest value; a parameter gradient
    (the card's from the whole model's backward) is a share of the model's
    largest gradient."""
    errors, ref_grads = {}, {}
    for name, rec in records.items():
        mod = reference.get_submodule(name)
        mod.train(training)
        mod.load_state_dict(rec["state"], strict=False)
        mod.zero_grad(set_to_none=True)
        dtype = next(mod.parameters()).dtype
        x = rec["input"].to(dtype).requires_grad_(
            rec["grad_input"] is not None)
        out = mod(x)
        out.backward(rec["grad_output"].to(out.dtype))
        errors[f"{name}:output"] = _rel_err(rec["output"],
                                            out.detach().double())
        if x.requires_grad:
            errors[f"{name}:input_grad"] = _rel_err(
                rec["grad_input"], x.grad.double())
        for key, buf in mod.named_buffers():
            errors[f"{name}:{key}"] = _rel_err(rec["new_state"][key],
                                               buf.double())
        prefix = name.replace(".", "/")
        for leaf in flax_leaves(mod):
            ref_grads[f"{prefix}/{leaf.name}"] = (
                leaf.to_flax(leaf.param.grad).double().numpy())
    largest = max(float(np.abs(g).max()) for g in ref_grads.values())
    for key, ref in ref_grads.items():
        errors[f"{key}:grad"] = float(
            np.abs(grads[key] - ref).max() / largest)
    return errors


def _grad_err(got, want):
    """The largest difference of any leaf as a share of the largest
    gradient of `want`, and the leaf where it lies."""
    largest = max(float(np.abs(g).max()) for g in want.values())
    errs = {k: float(np.abs(got[k] - want[k]).max()) / largest
            for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _zoo_card_vs_cpu(name, cls):
    """The float32 model at batch 2 of 224x224 images, the same weights
    and batch_stats on the card and on the CPU (BatchNorm scales, biases
    and running statistics moved off their initial values), in eval mode
    (BatchNorm reads its running statistics) and for one training forward
    and backward:

    - the logits, the loss and the updated batch_stats within
      ZOO_CHECK_RTOL of their largest value;
    - every Conv, BatchNorm and Linear module within ZOO_CHECK_RTOL: run
      alone on the CPU from the card's own input, buffers and output
      gradient, its output, input gradient and new buffers against their
      largest value, its parameter gradients against the model's largest;
    - in eval mode, the whole model's gradients within ZOO_CHECK_RTOL of
      the model's largest gradient;
    - in both modes, the whole model's gradients no farther from the
      float64 CPU's than ZOO_CHECK_EXACT_RATIO times the float32 CPU's.

    The training-mode gradients of the whole model are not held to
    ZOO_CHECK_RTOL of each other: their backward, through some 50
    training-mode BatchNorms at random weights, amplifies rounding, so
    that the float32 CPU's own gradients lie farther than that from the
    float64 ones (printed as `float32_vs_float64`), and a ReLU or max-pool
    input within rounding of its kink sends the gradient down the other
    branch. Each module alone has neither."""
    cpu, card, exact = _zoo_check_models(cls)
    images, labels = _zoo_images(ZOO_CHECK_BATCH, 50)
    result = {"phase": "zoo_card_vs_cpu", "model": name,
              "batch": ZOO_CHECK_BATCH,
              "cpu_threads": torch.get_num_threads(),
              "tolerance": {"values": ZOO_CHECK_RTOL,
                            "modules": ZOO_CHECK_RTOL,
                            "eval_model_grads": ZOO_CHECK_RTOL,
                            "exact_ratio": ZOO_CHECK_EXACT_RATIO}}
    failed = []
    for mode, training in (("eval", False), ("train", True)):
        recorder = _ModuleRecorder(card)
        try:
            values, grads = _zoo_step(card, images, labels, training)
        finally:
            recorder.close()
        cpu_values, cpu_grads = _zoo_step(cpu, images, labels, training)
        _, exact_grads = _zoo_step(exact, images, labels, training)
        value_err = {k: _rel_err(values[k], cpu_values[k])
                     for k in cpu_values}
        module_err = _module_errors(cpu, recorder.records, grads, training)
        del recorder
        card_exact, card_exact_at = _grad_err(grads, exact_grads)
        cpu_exact, cpu_exact_at = _grad_err(cpu_grads, exact_grads)
        bound = max(ZOO_CHECK_RTOL, ZOO_CHECK_EXACT_RATIO * cpu_exact)
        report = {
            "loss_card": float(values["loss"]),
            "loss_cpu": float(cpu_values["loss"]),
            "worst_values": sorted(value_err.items(),
                                   key=lambda kv: -kv[1])[:3],
            "modules": len({k.split(":")[0] for k in module_err}),
            "worst_modules": sorted(module_err.items(),
                                    key=lambda kv: -kv[1])[:3],
            "model_grads": {
                "card_vs_cpu": _grad_err(grads, cpu_grads),
                "card_vs_float64": (card_exact, card_exact_at),
                "float32_vs_float64": (cpu_exact, cpu_exact_at),
                "bound": bound},
        }
        result[mode] = report
        if report["worst_values"][0][1] > ZOO_CHECK_RTOL:
            failed.append(f"{mode} values")
        if report["worst_modules"][0][1] > ZOO_CHECK_RTOL:
            failed.append(f"{mode} modules")
        if card_exact > bound:
            failed.append(f"{mode} model gradients against float64")
        if not training and report["model_grads"]["card_vs_cpu"][0] > \
                ZOO_CHECK_RTOL:
            failed.append("eval model gradients")
    emit(result)
    if failed:
        raise AssertionError(f"zoo {name} card against CPU: {failed}")
    return result


def _zoo_small_records(name, root, n):
    """Training data for a small zoo job: an .edlr file (a CSV file for
    iris) of n records."""
    if name == "iris":
        return iris_dnn.make_csv(os.path.join(root, "iris.csv"), n=n)
    if name in ("mnist", "cifar10"):
        shape = (28, 28) if name == "mnist" else (32, 32, 3)
        images, labels = _zoo_images(n, 70, shape)
        records = [encode_example({"image": image, "label": label})
                   for image, label in zip(images, labels)]
    else:
        records = ZOO_SMALL[name][1].make_records(n, seed=4)
    path = os.path.join(root, f"{name}.edlr")
    with RecordFileWriter(path) as writer:
        for record in records:
            writer.write(record)
    return path


def _zoo_small_job(name, root):
    """A short job through the master on the card: ZOO_SMALL_RECORDS
    records, ZOO_SMALL_EPOCHS epochs in minibatches of ZOO_SMALL_BATCH;
    records_done exact and the loss falling."""
    spec, _, strategy = ZOO_SMALL[name]
    data = _zoo_small_records(name, root, ZOO_SMALL_RECORDS)
    common = [
        "--model_def", spec, "--distribution_strategy", strategy,
        "--training_data", data,
        "--records_per_task", str(2 * ZOO_SMALL_BATCH),
        "--num_epochs", str(ZOO_SMALL_EPOCHS),
        "--minibatch_size", str(ZOO_SMALL_BATCH), "--seed", "0",
    ]
    ps = strategy == "ParameterServerStrategy"
    master, _, worker = _job(
        common, ["--job_type", "training_only", "--log_loss_steps", "1"],
        num_ps=PS_SHARDS if ps else 0)
    start = time.perf_counter()
    with _logged_losses() as lines:
        worker.run()
        if ps:
            worker.trainer.close()
    wall_s = time.perf_counter() - start
    losses = [loss for _, loss, _ in lines]
    records_done = master.task_d.stats()["records_done"]
    want = ZOO_SMALL_RECORDS * ZOO_SMALL_EPOCHS
    result = {"model": name, "strategy": strategy,
              "records_done": records_done, "steps": worker.steps,
              "wall_s": wall_s, "first_losses": losses[:4],
              "last_losses": losses[-4:]}
    if not (master.task_d.finished() and not master.task_d.job_failed
            and records_done == want
            and all(math.isfinite(x) for x in losses)
            and np.mean(losses[-4:]) < np.mean(losses[:4])):
        raise AssertionError(f"zoo small job {name}: {result}")
    return result


def phase_zoo():
    """The image and tabular zoo on the card: ResNet-50 and MobileNetV2 at
    full width, direct and (ResNet-50) through the master with a
    checkpoint round trip; both against the CPU in float32; a short job
    of each small model through the master. None launches a
    flash-attention kernel."""
    fa.reset_launch_counts()
    results = {}
    for name, module, batch in ZOO_DIRECT:
        trainer, results[name] = _zoo_direct(name, module, batch)
        del trainer
    with tempfile.TemporaryDirectory() as root:
        results["resnet50_job"] = _zoo_job(root)
    torch.cuda.empty_cache()
    results["resnet50_ps"] = _zoo_ps()
    for name, cls in (("resnet50", resnet50.ResNet50),
                      ("mobilenetv2", mobilenetv2.MobileNetV2)):
        results[f"{name}_card_vs_cpu"] = _zoo_card_vs_cpu(name, cls)
    small = {}
    with tempfile.TemporaryDirectory() as root:
        for name in ZOO_SMALL:
            small[name] = _zoo_small_job(name, root)
    emit({"phase": "zoo_small", "jobs": small})
    launches = dict(fa.launches)
    emit({"phase": "zoo", "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"zoo launches {launches}")
    results["launches"] = launches
    return results


# The processes phase: the job across processes, every process on the one
# card. proc_lm: the flagship LM (training only) through master.main with
# two worker processes, 64 records in tasks of 16; once 16 records are
# done worker 0 is stopped and worker 1 SIGKILLed and relaunched by the
# instance manager, once 40 are done worker 0 is continued, the master
# SIGKILLed and relaunched with --instance_backend none over
# its journal and port. proc_ps: DeepFM-PS on ps_job's data through
# master.main with 2 PS processes and one worker; shard 0 is SIGKILLed once
# 65,536 records are done and relaunched on its port. Every wait on a
# process of a job ends after PROC_TIMEOUT seconds.
PROC_LM_WORKERS = 2
PROC_LM_KILL_WORKER_AT = 16
PROC_LM_KILL_MASTER_AT = 40
PROC_PS_KILL_SHARD_AT = 65536
PROC_LM_PATIENCE_S = 30
PROC_LM_PUSH_INTERVAL_S = 0.5
PROC_TIMEOUT = 240
# The transport on loopback: small calls and one 64 MiB push, in this
# process; the native and Python record readers on READER_RECORDS records.
TRANSPORT_SMALL_CALLS = 2000
TRANSPORT_PUSH_MB = 64
TRANSPORT_PUSHES = 8
READER_RECORDS = 16384
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def _proc_master(argv, env, log_path):
    """master.main in a process group of its own (its children join it),
    its output (and its children's) to log_path. The group stays in this
    process's session, so it is not orphaned while this process lives: an
    orphaned group that holds a stopped process is sent SIGHUP when one of
    its members exits (a kernel may do so at any member's exit)."""
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.master.main", *argv],
            cwd=REPO_DIR, env=env, stdout=log, stderr=subprocess.STDOUT,
            process_group=0)


def _proc_wait(predicate, what, proc=None, timeout=PROC_TIMEOUT):
    end = time.time() + timeout
    while time.time() < end:
        value = predicate()
        if value:
            return value
        if proc is not None and proc.poll() is not None:
            raise AssertionError(
                f"master exited ({proc.returncode}) waiting for {what}")
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _proc_port(log_path, proc):
    def port():
        with open(log_path, errors="replace") as f:
            found = re.search(r"Master serving on port (\d+)", f.read())
        return int(found.group(1)) if found else None

    return _proc_wait(port, "the master's port", proc)


def _proc_status(port):
    """-> a callable giving the master's JobStatusResponse (an empty one
    while the master does not answer)."""
    stub = rpc.Stub(rpc.build_channel(f"127.0.0.1:{port}", ready_timeout=0),
                    rpc.MASTER_SERVICE)

    def status():
        try:
            return stub.get_job_status(pb.GetJobStatusRequest(), timeout=5)
        except rpc.RpcError:
            return pb.JobStatusResponse()

    return status


def _accepting_after(port, since):
    """Seconds from `since` until 127.0.0.1:port accepts a connection
    again, after it refused one (polled every 2 ms): a SIGKILLed process's
    listener closes only once the process is gone."""
    end = time.time() + PROC_TIMEOUT
    refused = False
    while time.time() < end:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.05).close()
            if refused:
                return time.time() - since
        except OSError:
            refused = True
        time.sleep(0.002)
    raise AssertionError(f"port {port} did not accept again")


def _proc_env(**extra):
    env = dict(os.environ)
    for name in ("ELASTICDL_TORCH_DEVICE", "ELASTICDL_CHAOS",
                 "ELASTICDL_MASTER_JOURNAL_DIR", "ELASTICDL_OBS_DIR"):
        env.pop(name, None)  # the card, no faults but the drill's kills
    env.update({"ELASTICDL_HEARTBEAT_SECONDS": "0",
                "ELASTICDL_METRICS_PORT": "-1",
                "PYTHONPATH": REPO_DIR}, **extra)
    return env


def _trace_spans(obs_dir, role):
    path = os.path.join(obs_dir, f"trace_{role}.jsonl")
    spans = []
    with open(path) as f:
        for line in f:
            event = json.loads(line)
            if event.get("ph") == "X":
                spans.append(event)
    return spans


def _first_after(spans, name_end, since, end=False, ok=False):
    """Seconds from `since` to the start (end=True: the end) of the first
    span named ...name_end that starts after `since` (ok=True: of a call
    that ended OK)."""
    times = [(s["ts"] + (s["dur"] if end else 0)) / 1e6 for s in spans
             if s["name"].endswith(name_end) and s["ts"] / 1e6 > since
             and (not ok or s.get("args", {}).get("code") == "OK")]
    return min(times) - since if times else None


_TIMELINE = (
    ("master_serving", r"Master serving on port"),
    ("launched", r"Launched (\w+ \d+)"),
    ("model_built", r"Initialized model"),
    ("first_step", r"Step 1 \("),
    ("exited", r"(\w+ \d+) exited with code"),
    ("relaunching", r"Relaunching (\w+ \d+)"),
    ("journal_replayed", r"Master journal replayed"),
    ("master_unreachable", r"Master unreachable"),
    ("channel_rebuilt", r"rebuilt the channel"),
    ("shard_degraded", r"PS shard \d+ degraded"),
    ("shard_healthy", r"PS shard \d+ healthy again"),
    ("job_done", r"All tasks complete"),
    ("worker_exit", r"Worker (\d+) exiting"),
)


def _timeline(text, start):
    """[(seconds since `start`, marker)] of the job's log lines that mark
    its lifecycle, in order (log times are the host's local clock, to the
    millisecond)."""
    out = []
    for line in text.splitlines():
        stamp = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]",
                         line)
        if not stamp:
            continue
        for name, pattern in _TIMELINE:
            found = re.search(pattern, line)
            if found:
                t = time.mktime(time.strptime(stamp.group(1),
                                              "%Y-%m-%d %H:%M:%S"))
                label = f"{name} {found.group(1)}" if found.groups() else name
                out.append((round(t + int(stamp.group(2)) / 1e3 - start, 3),
                            label))
                break
    return sorted(out)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _print_log_tails(paths, lines=60):
    """The last lines of a failed job's logs, to stderr."""
    for path in paths:
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                tail = f.read().splitlines()[-lines:]
            print(f"--- last {len(tail)} lines of {os.path.basename(path)}",
                  *tail, sep="\n", file=sys.stderr)


def _proc_teardown(procs, port):
    """Kills what is left of a job: each master's process group, then any
    process that still carries the job's master address."""
    from elasticdl_tpu_torch.chaos import process as chaos_process

    for proc in procs:
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)
    if port is not None:
        for pid, _ in chaos_process.find_job_pids(port):
            chaos_process.deliver(pid, signal.SIGKILL)


def _exit_lines(text, role):
    """{"worker-<id>": [exit record, ...]} of the processes of one kind
    (role "Worker" or "PS") that logged an exit line, in log order."""
    out = {}
    prefix = "worker" if role == "Worker" else "ps"
    for rid, body in re.findall(rf"{role} (\d+) exiting: (\{{.*\}})", text):
        out.setdefault(f"{prefix}-{rid}", []).append(json.loads(body))
    return out


def _push_summary(exits):
    """Per role: telemetry pushes, accepted snapshots, bytes per push
    (failed ones included) and ms per answered push, from the processes'
    exit lines."""
    out = {}
    for role, records in exits.items():
        t = records[-1]["telemetry"]
        out[role] = {**t, "bytes_per_push": t["payload_bytes"]
                     / max(t["pushes"], 1),
                     "ms_per_push": 1e3 * t["seconds"] / max(
                         t["pushes"], 1)}
    return out


def _push_tally(text):
    """The last "Telemetry pushes accepted" line a master logged at its
    stop: {role: {"snapshots", "payload_bytes"}}, or None."""
    found = re.findall(r"Telemetry pushes accepted: (\{.*\})", text)
    return json.loads(found[-1]) if found else None


def _proc_lm(root):
    """The flagship LM across processes with a worker kill and a master
    kill; returns the recovery times and the checks' inputs."""
    from elasticdl_tpu_torch.chaos import process as chaos_process

    cfg = proc_config()
    paths, _ = _write_job_inputs(root, cfg, n_valid=0)
    obs = os.path.join(root, "metrics")
    # A worker whose wait for work outlasts the finished successor's 2 s
    # linger rides the master's absence for the patience window before it
    # exits, so the window is cut from 120 s to PROC_LM_PATIENCE_S, well
    # over the master's outage.
    # Worker 0 is stopped at PROC_LM_KILL_WORKER_AT records, some 3 s after
    # its telemetry reporter starts: pushes every PROC_LM_PUSH_INTERVAL_S
    # (the default's 2 s, jittered, can fall after the stop) so that each
    # worker's telemetry reaches the master before the drill begins.
    env = _proc_env(
        ELASTICDL_MASTER_JOURNAL_DIR=os.path.join(root, "journal"),
        ELASTICDL_MASTER_PATIENCE_SECONDS=str(PROC_LM_PATIENCE_S),
        ELASTICDL_TELEMETRY_PUSH_INTERVAL=str(PROC_LM_PUSH_INTERVAL_S))
    argv = ["--model_def", paths["model_def"],
            "--distribution_strategy", "Local",
            "--training_data", paths["train"],
            "--records_per_task", str(JOB_RECORDS_PER_TASK),
            "--num_epochs", "1", "--minibatch_size", str(BATCH),
            "--log_loss_steps", "1", "--metrics_dir", obs,
            "--job_name", "proc-lm", "--task_timeout_check_seconds", "1",
            "--seed", "0"]
    logs = [os.path.join(root, f"master{i}.log") for i in (1, 2)]
    start = time.time()
    first = _proc_master(argv + [
        "--instance_backend", "local_process",
        "--num_workers", str(PROC_LM_WORKERS), "--master_port", "0"],
        env, logs[0])
    second = port = None
    try:
        port = _proc_port(logs[0], first)
        status = _proc_status(port)
        _proc_wait(lambda: status().records_done >= PROC_LM_KILL_WORKER_AT,
                   f"{PROC_LM_KILL_WORKER_AT} records", first)
        # A relaunched flagship worker needs ~20 s to build its model;
        # worker 0 alone would finish the job's last 48 records in less.
        # So worker 0 is stopped (SIGSTOP) before worker 1 is killed: the
        # tasks left wait for the relaunched worker 1, and worker 0 keeps
        # the one it holds until it is continued at the master's kill.
        stopped = chaos_process.find_role_pid("worker", 0, port,
                                              timeout=PROC_TIMEOUT)
        chaos_process.deliver(stopped, signal.SIGSTOP)
        worker_kill = time.time()
        chaos_process.kill_role("worker", 1, port, timeout=PROC_TIMEOUT)
        _proc_wait(lambda: status().records_done >= PROC_LM_KILL_MASTER_AT,
                   f"{PROC_LM_KILL_MASTER_AT} records", first)
        relaunches = status().relaunches
        # Worker 0 is continued just before the master's kill: a group
        # whose parent dies is orphaned, and one holding a stopped process
        # then gets SIGHUP. Its task is mid-step, far from its report.
        chaos_process.deliver(stopped, signal.SIGCONT)
        continued = master_kill = time.time()
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)
        orphans = len(chaos_process.find_job_pids(port))
        second = _proc_master(argv + ["--instance_backend", "none",
                                      "--master_port", str(port)],
                              env, logs[1])
        accepting_s = _accepting_after(port, master_kill)
        rc = second.wait(timeout=PROC_TIMEOUT)
        _proc_wait(lambda: not chaos_process.find_job_pids(port),
                   "the workers' exit")
        wall_s = time.time() - start
    except BaseException:
        _print_log_tails(logs)
        raise
    finally:
        _proc_teardown((first, second), port)
    text = "".join(open(p, errors="replace").read() for p in logs)
    losses = [float(x) for x in re.findall(r"\) loss (\S+)", text)]
    spans = {f"worker-{i}": _trace_spans(obs, f"worker-{i}")
             for i in range(PROC_LM_WORKERS)}
    step_ms = {role: float(np.median([s["dur"] / 1e3 for s in sp
                                      if s["name"] == "batch_process"]))
               for role, sp in spans.items()}
    all_spans = [s for sp in spans.values() for s in sp]
    events = _jsonl(os.path.join(obs, "events.jsonl"))
    trains = [m for m in _jsonl(os.path.join(obs, "metrics.jsonl"))
              if m["group"] == "train"]
    # The relaunched worker 1's accepted reports to the first master: with
    # worker 0 stopped, every record done between the kills is its work.
    relaunched_reports = sum(
        1 for s in spans["worker-1"]
        if s["name"].endswith("/report_task_result")
        and worker_kill < s["ts"] / 1e6
        and (s["ts"] + s["dur"]) / 1e6 < master_kill
        and s.get("args", {}).get("code") == "OK")
    exits = _exit_lines(text, "Worker")
    return {
        "timeline": _timeline(text, start),
        "worker_kill_at_s": worker_kill - start,
        "master_kill_at_s": master_kill - start,
        "worker_0_stopped_s": continued - worker_kill,
        "successor_rc": rc, "wall_s": wall_s,
        "records_done": trains[-1]["records_done"] if trains else None,
        "relaunches_before_master_kill": relaunches,
        "pod_relaunch": [e["instance"] for e in events
                         if e["kind"] == "pod_relaunch"],
        "master_recovered": [e.get("incarnation") for e in events
                             if e["kind"] == "master_recovered"],
        "orphans_at_master_kill": orphans,
        "losses": losses,
        "ms_per_step_by_worker": step_ms,
        # Each worker process's exit line: its steps, its kernel launches
        # and its telemetry pushes (worker 1's first process was killed).
        "worker_exits": exits,
        "telemetry_push": _push_summary(exits),
        "telemetry_push_accepted_by_successor": _push_tally(
            open(logs[1], errors="replace").read()),
        "relaunched_worker_reports_before_master_kill": relaunched_reports,
        # The relaunched process ready to work (its first get_task) and
        # its recovery: its first accepted task report.
        "worker_kill_to_first_get_task_s": _first_after(
            spans["worker-1"], "/get_task", worker_kill),
        "relaunched_first_get_task_code": next(
            (s["args"].get("code") for s in sorted(
                spans["worker-1"], key=lambda s: s["ts"])
             if s["name"].endswith("/get_task")
             and s["ts"] / 1e6 > worker_kill), None),
        "worker_kill_to_first_report_s": _first_after(
            spans["worker-1"], "/report_task_result", worker_kill, end=True,
            ok=True),
        "master_kill_to_accepting_s": accepting_s,
        # The successor's first dispatch decision a worker receives (a
        # task, WAIT or the job's end) and its first accepted report.
        "master_kill_to_first_get_task_answered_s": _first_after(
            all_spans, "/get_task", master_kill, end=True, ok=True),
        "master_kill_to_first_report_accepted_s": _first_after(
            all_spans, "/report_task_result", master_kill, end=True,
            ok=True),
        "failed_attempts_by_code": _failed_attempts(all_spans),
    }


def _failed_attempts(spans):
    """Client call attempts that did not end OK, by method and status."""
    counts = {}
    for s in spans:
        code = s.get("args", {}).get("code")
        if s["name"].startswith("rpc_client") and code not in (None, "OK"):
            key = f"{s['name'].rsplit('/', 1)[-1]}:{code}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def _proc_ps(root):
    """DeepFM-PS across processes with shard 0 killed mid-job."""
    from elasticdl_tpu_torch.chaos import process as chaos_process

    paths = _write_ps_job_inputs(root)
    obs = os.path.join(root, "metrics")
    argv = ["--model_def", PS_SPEC,
            "--distribution_strategy", "ParameterServerStrategy",
            "--num_ps", str(PS_SHARDS), "--num_workers", "1",
            "--instance_backend", "local_process", "--master_port", "0",
            "--training_data", paths["train"],
            "--validation_data", paths["valid"],
            "--records_per_task", str(PS_JOB_TASK),
            "--num_epochs", "1", "--minibatch_size", str(PS_JOB_BATCH),
            "--evaluation_steps", str(PS_JOB_EVAL_STEPS),
            "--log_loss_steps", "4", "--metrics_dir", obs,
            "--job_name", "proc-ps", "--task_timeout_check_seconds", "1",
            "--seed", "0"]
    log = os.path.join(root, "master.log")
    start = time.time()
    master = _proc_master(argv, _proc_env(), log)
    port = None
    try:
        port = _proc_port(log, master)
        status = _proc_status(port)
        _proc_wait(lambda: status().records_done >= PROC_PS_KILL_SHARD_AT,
                   f"{PROC_PS_KILL_SHARD_AT} records", master)
        shard_kill = time.time()
        chaos_process.kill_role("ps", 0, port, timeout=PROC_TIMEOUT)
        accepting_s = _accepting_after(port + 1, shard_kill)
        rc = master.wait(timeout=PROC_TIMEOUT)
        _proc_wait(lambda: not chaos_process.find_job_pids(port),
                   "the job's processes' exit")
        wall_s = time.time() - start
    except BaseException:
        _print_log_tails([log])
        raise
    finally:
        _proc_teardown((master,), port)
    text = open(log, errors="replace").read()
    losses = [float(x) for x in re.findall(r"\) loss (\S+)", text)]
    worker = _trace_spans(obs, "worker-0")
    steps = [s for s in worker if s["name"] == "batch_process"]
    ps_bytes = sum(s["args"].get("sent", 0) + s["args"].get("received", 0)
                   for s in worker if "/elasticdl_tpu.Pserver/" in s["name"])
    metrics = _jsonl(os.path.join(obs, "metrics.jsonl"))
    events = _jsonl(os.path.join(obs, "events.jsonl"))
    return {
        "timeline": _timeline(text, start),
        "shard_kill_at_s": shard_kill - start,
        "master_rc": rc, "wall_s": wall_s,
        "records_done": [m["records_done"] for m in metrics
                         if m["group"] == "train"][-1:],
        "evals": [m for m in metrics if m["group"] == "eval"],
        # Evaluations the master completed (its evaluation service logs
        # each); a round a PS's liveness report_version opens while the
        # finished master lingers never runs.
        "evals_completed": len(re.findall(r"Evaluation @ version", text)),
        "eval_rounds_opened": sum(
            1 for e in events if e["kind"] == "task_create"
            and e.get("type") == "EVALUATION"),
        "pod_relaunch": [e["instance"] for e in events
                         if e["kind"] == "pod_relaunch"],
        "losses": losses,
        "batches": len(steps),
        "ms_per_step": float(np.median([s["dur"] / 1e3 for s in steps])),
        "ps_bytes_per_batch": ps_bytes / max(len(steps), 1),
        "shard_kill_to_accepting_s": accepting_s,
        "shard_kill_to_first_push_s": _first_after(
            _trace_spans(obs, "ps-0"), "/push_gradients_packed",
            shard_kill, end=True),
        "failed_attempts_by_code": _failed_attempts(worker),
        # Telemetry pushes: the worker's side from its exit line, and
        # what the master's aggregator accepted by role, from its stop.
        "telemetry_push": _push_summary(_exit_lines(text, "Worker")),
        "telemetry_push_accepted_by_master": _push_tally(text),
    }


class _Sink:
    """A PS servicer that answers every push at once, for the transport's
    own costs."""

    def __getattr__(self, method):
        return lambda request, context: rpc.PSERVER_SERVICE.methods[
            method][1]()


def _transport_loopback():
    """ms per small call and GB/s of 64 MiB pushes over the socket
    transport on 127.0.0.1, in this process."""
    server, port = rpc.serve(_Sink(), rpc.PSERVER_SERVICE)
    channel = rpc.build_channel(f"127.0.0.1:{port}")
    stub = rpc.Stub(channel, rpc.PSERVER_SERVICE)
    try:
        small = pb.PullDenseParametersRequest(version=1)
        for _ in range(100):
            stub.pull_dense_parameters(small)
        start = time.perf_counter()
        for _ in range(TRANSPORT_SMALL_CALLS):
            stub.pull_dense_parameters(small)
        small_ms = 1e3 * (time.perf_counter() - start) / TRANSPORT_SMALL_CALLS
        payload = np.random.default_rng(0).standard_normal(
            TRANSPORT_PUSH_MB * 2**18).astype(np.float32)
        push = pb.Model(dense_parameters=[
            tensor_utils.ndarray_to_tensor_pb(payload, "w")])
        stub.push_model(push)
        start = time.perf_counter()
        for _ in range(TRANSPORT_PUSHES):
            stub.push_model(push)
        push_s = (time.perf_counter() - start) / TRANSPORT_PUSHES
    finally:
        channel.close()
        server.stop(0)
    return {"small_call_ms": small_ms,
            "push_mib": TRANSPORT_PUSH_MB, "push_ms": 1e3 * push_s,
            "push_gb_per_s": push.ByteSize() / push_s / 1e9}


def _record_reader(root):
    """ms per record of a whole-file range read, native and Python."""
    from elasticdl_tpu_torch.data.recordfile import RecordFile

    path = os.path.join(root, "reader.edlr")
    with RecordFileWriter(path) as writer:
        for record in iter_criteo_records(READER_RECORDS, seed=3):
            writer.write(record)
    out = {}
    for name, no_native in (("native", ""), ("python", "1")):
        with _environ(EDL_NO_NATIVE=no_native):
            rf = RecordFile(path)
            got = list(rf.read(0, READER_RECORDS))
            start = time.perf_counter()
            got = list(rf.read(0, READER_RECORDS))
            out[f"{name}_ms_per_record"] = (
                1e3 * (time.perf_counter() - start) / READER_RECORDS)
            rf.close()
        out.setdefault("records", len(got))
    return out


def phase_processes(results):
    """The job across processes on the card: the transport on loopback,
    the record readers, then proc_lm and proc_ps with their drills."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        transport = _transport_loopback()
        reader = _record_reader(root)
    emit({"phase": "processes", **card, "transport": transport,
          "record_reader": reader})
    with tempfile.TemporaryDirectory() as root:
        lm = _proc_lm(root)
    emit({"phase": "processes", "run": "proc_lm", **card,
          "workers_share_the_card": PROC_LM_WORKERS, **lm})
    exits = lm["worker_exits"]
    layers = PROC_LAYERS
    checks = [
        (lm["successor_rc"] == 0, "the successor's exit code"),
        (lm["records_done"] == JOB_TRAIN_RECORDS, "records_done"),
        (lm["pod_relaunch"] == ["worker-1"], "worker 1 relaunched once"),
        (lm["master_recovered"] == [2], "incarnation 2, master_recovered"),
        (lm["orphans_at_master_kill"] == PROC_LM_WORKERS,
         "the workers outlive the master"),
        (lm["losses"] and all(math.isfinite(x) for x in lm["losses"]),
         "finite losses"),
        (lm["relaunched_worker_reports_before_master_kill"] >= 1
         and lm["worker_kill_to_first_report_s"] is not None,
         "the relaunched worker reported a task"),
        (sorted(exits) == [f"worker-{i}" for i in range(PROC_LM_WORKERS)]
         and all(len(v) == 1 for v in exits.values()),
         "one exit line per worker id"),
        # Each worker process ran its steps through the hand-written
        # kernels: one forward-with-lse, dQ and dK/dV per layer and step,
        # and no plain forward (the job has no evaluation).
        (all(e["steps"] > 0 and {k: v for k, v in e["kernel_launches"]
                                 .items() if v}
             == {n: layers * e["steps"]
                 for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
             for v in exits.values() for e in v),
         "each worker process's kernel launches"),
        (all(t["accepted"] >= 1 for t in lm["telemetry_push"].values()),
         "each worker's telemetry pushes accepted"),
        (lm["master_kill_to_first_get_task_answered_s"] is not None
         and lm["master_kill_to_first_report_accepted_s"] is not None,
         "the successor answered the workers"),
    ]
    with tempfile.TemporaryDirectory() as root:
        ps = _proc_ps(root)
    emit({"phase": "processes", "run": "proc_ps", **card, **ps,
          "in_process_ps_step_f32_pipelined_ms": results["ps_step"][
              "f32_pipelined"]["ms_per_step"],
          "in_process_ps_job_wall_s": results["ps_job"]["wall_s"]})
    checks += [
        (ps["master_rc"] == 0, "the PS job's exit code"),
        (ps["records_done"] == [PS_JOB_TRAIN], "PS records_done"),
        (ps["evals"] and len(ps["evals"]) == ps["evals_completed"]
         and all({"auc", "accuracy"} <= set(m) for m in ps["evals"]),
         "every PS evaluation in metrics.jsonl"),
        (ps["pod_relaunch"] == ["ps-0"], "shard 0 relaunched once"),
        (ps["losses"] and all(math.isfinite(x) for x in ps["losses"]),
         "PS finite losses"),
        (ps["shard_kill_to_first_push_s"] is not None,
         "the relaunched shard took a push"),
        (sorted(ps["telemetry_push_accepted_by_master"] or ())
         == ["ps-0", "ps-1", "worker-0"]
         and all(t["snapshots"] >= 1 for t in
                 ps["telemetry_push_accepted_by_master"].values()),
         "the PS job's telemetry pushes accepted"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"processes phase: {failed}")
    return {"proc_lm": lm, "proc_ps": ps, "transport": transport,
            "record_reader": reader}


# The `edl` client on the card: the flagship trained with `edl train`
# (CLIENT_TRAIN records in tasks of CLIENT_TASK, training only, exported),
# CLIENT_PREDICT records predicted from that export with `edl predict`,
# and the MNIST CNN trained and evaluated (its report fits under the
# transport's cap; the flagship's 2 GiB one does not, as in the JAX
# package). Each command runs the master in its own process and one
# worker process.
CLIENT_TRAIN = 32
CLIENT_PREDICT = 8
CLIENT_TASK = 16
CLIENT_MNIST_TRAIN = 256
CLIENT_MNIST_VALID = 64
CLIENT_MNIST_BATCH = 32
CLIENT_LOGITS_RTOL = 1e-4
CLIENT_TIMEOUT = 300
# The predict job's model definition: MODEL_DEF with a prediction-outputs
# processor that saves each minibatch's last-position logits.
CLIENT_PREDICT_DEF = MODEL_DEF + """

import numpy as _np


class _LastLogits:
    def __init__(self):
        self.rows = []

    def process(self, predictions, worker_id):
        self.rows.append(_np.asarray(predictions)[:, -1])

    def close(self):
        _np.save({out!r}, _np.concatenate(self.rows))


prediction_outputs_processor = _LastLogits()
"""


def _edl(command, argv, env, log_path, timeout=CLIENT_TIMEOUT):
    """`python -m elasticdl_tpu_torch.client.main <command> <argv>` in a
    process group of its own, its output (and its children's) to log_path;
    -> (exit code, seconds, log text). The group is killed on the way
    out."""
    start = time.time()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
             command, *argv],
            cwd=REPO_DIR, env=env, stdout=log, stderr=subprocess.STDOUT,
            process_group=0)
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    with open(log_path, errors="replace") as f:
        text = f.read()
    return rc, time.time() - start, text


def _edl_run(name, command, argv, env, root, logs):
    """One `edl` command of the client phase -> its record (exit code,
    wall, its processes' timeline and the worker's exit lines); a
    nonzero exit raises."""
    log = os.path.join(root, f"{name}.log")
    logs.append(log)
    start = time.time()
    rc, wall_s, text = _edl(command, argv, env, log)
    record = {"rc": rc, "wall_s": wall_s,
              "timeline": _timeline(text, start),
              "worker_exits": _exit_lines(text, "Worker")}
    if rc != 0:
        raise AssertionError(f"edl {command} ({name}) exited {rc}")
    return record, text


def _client_reference(ckpt, records):
    """The flagship's last-position logits on the prediction `records`, by
    this process on the card from the exported weights, minibatch by
    minibatch as the predict worker ran them."""
    cfg = proc_config()
    trainer = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer())
    trainer.restore_on_init = ckpt
    rows = []
    for i in range(0, len(records), BATCH):
        features, _ = tlm.feed(records[i:i + BATCH], Modes.PREDICTION, None)
        rows.append(trainer.evaluate_minibatch(features)[:, -1])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return np.concatenate(rows)


def _launch_check(exits, counts):
    """Each worker process's flash-attention launches as its exit line
    gives them, against {kernel: launches per step, or "fwd": per
    predicted minibatch}; True if all exact."""
    ok = bool(exits)
    for records in exits.values():
        for e in records:
            got = {k: v for k, v in e["kernel_launches"].items() if v}
            ok = ok and got == counts(e)
    return ok


def phase_client(results):
    """`edl train`, `edl predict` and `edl evaluate` through the port's
    client on the card."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    layers = PROC_LAYERS
    env = _proc_env()
    logs = []
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        try:
            cfg = proc_config()
            paths, _ = _write_job_inputs(root, cfg, n_train=CLIENT_TRAIN,
                                         n_valid=CLIENT_PREDICT)
            rf = RecordFile(paths["valid"])
            predict_records = list(rf.read(0, CLIENT_PREDICT))
            rf.close()
            out = os.path.join(root, "last_logits.npy")
            predict_def = os.path.join(root, "lm_predict_def.py")
            with open(predict_def, "w") as f:
                f.write(CLIENT_PREDICT_DEF.format(seq=SEQ, out=out,
                                                  layers=PROC_LAYERS))
            ckpt = os.path.join(root, "flagship.npz")
            common = ["--distribution_strategy", "Local",
                      "--num_workers", "1", "--master_port", "0",
                      "--task_timeout_check_seconds", "1", "--seed", "0",
                      "--minibatch_size", str(BATCH)]
            train, _ = _edl_run("train", "train", [
                "--model_def", paths["model_def"],
                "--training_data", paths["train"],
                "--records_per_task", str(CLIENT_TASK),
                "--num_epochs", "1", "--log_loss_steps", "1",
                "--output", ckpt, "--job_name", "client-train", *common],
                env, root, logs)
            predict, _ = _edl_run("predict", "predict", [
                "--model_def", predict_def,
                "--prediction_data", paths["valid"],
                "--records_per_task", str(CLIENT_PREDICT),
                "--checkpoint_dir_for_init", ckpt,
                "--job_name", "client-predict", *common], env, root, logs)
            got = np.load(out)
            want = _client_reference(ckpt, predict_records)
            err = float(np.abs(got - want).max()) if got.shape == (
                want.shape) else math.inf
            rel = err / max(float(np.abs(want).max()), 1e-30)
            mnist = {}
            mnist_data = {}
            for split, n in (("train", CLIENT_MNIST_TRAIN),
                             ("valid", CLIENT_MNIST_VALID)):
                split_root = os.path.join(root, f"mnist_{split}")
                os.makedirs(split_root)
                mnist_data[split] = _zoo_small_records(
                    "mnist", split_root, n)
            mnist_ckpt = os.path.join(root, "mnist.npz")
            obs = os.path.join(root, "mnist_metrics")
            mnist_common = [
                "--model_def", ZOO_SMALL["mnist"][0],
                "--records_per_task", str(2 * CLIENT_MNIST_BATCH),
                *common[:-1], str(CLIENT_MNIST_BATCH)]
            mnist["train"], _ = _edl_run("mnist_train", "train", [
                "--training_data", mnist_data["train"], "--num_epochs", "2",
                "--output", mnist_ckpt, "--job_name", "client-mnist",
                *mnist_common], env, root, logs)
            mnist["evaluate"], _ = _edl_run("mnist_evaluate", "evaluate", [
                "--validation_data", mnist_data["valid"],
                "--checkpoint_dir_for_init", mnist_ckpt,
                "--metrics_dir", obs, "--job_name", "client-mnist-eval",
                *mnist_common], env, root, logs)
            evals = [m for m in _jsonl(os.path.join(obs, "metrics.jsonl"))
                     if m["group"] == "eval"]
        except BaseException:
            _print_log_tails(logs)
            raise
    emit({"phase": "client", **card, "train": train, "predict": predict,
          "predict_last_logits_max_abs_err": err,
          "predict_last_logits_rel_err": rel, "mnist": mnist,
          "mnist_evals": evals})
    steps = CLIENT_TRAIN // BATCH
    batches = CLIENT_PREDICT // BATCH
    trains = {n: layers for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
    checks = [
        (len(train["worker_exits"].get("worker-0", [])) == 1
         and train["worker_exits"]["worker-0"][0]["steps"] == steps,
         "the train worker's steps"),
        # Training runs the three training kernels once per layer and
        # step and no plain forward.
        (_launch_check(train["worker_exits"], lambda e: {
            n: k * e["steps"] for n, k in trains.items()}),
         "the train worker's kernel launches"),
        # Prediction runs the forward without lse, once per layer and
        # predicted minibatch, and nothing else.
        (_launch_check(predict["worker_exits"], lambda e: {
            "flash_fwd": layers * batches}), "the predict worker's launches"),
        (got.shape == (CLIENT_PREDICT, cfg.vocab)
         and np.isfinite(got).all(), "the predicted logits' shape"),
        (rel <= CLIENT_LOGITS_RTOL, "predicted logits vs this process's"),
        (evals and all("accuracy" in m and math.isfinite(m["accuracy"])
                       for m in evals), "MNIST evaluation in metrics.jsonl"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"client phase: {failed}")
    return {"train": train, "predict": predict, "mnist": mnist,
            "predict_last_logits_rel_err": rel}


# The k8s backend on the card: the flagship submitted with `edl train
# --instance_backend k8s` against tests/fake_k8s_server.py (K8S_RECORDS
# records in tasks of K8S_TASK, one worker pod, training only), the pods
# run by _Kubelet; the worker pod is preempted after its first accepted
# report and relaunched by the master.
K8S_RECORDS = 48
K8S_TASK = 16
K8S_NS = "default"
K8S_JOB = "k8s-lm"
K8S_GRACE_S = 30


class _Kubelet:
    """Plays kubelet for a fake API server: each pod created there runs as
    a local process (its container's command, `python` resolved to this
    interpreter, the container's env values over `env`, MY_POD_IP
    127.0.0.1) in a process group of its own, its output to
    <root>/<pod>.log. It reports Running at the start and Succeeded, or
    Failed with the exit code, at the exit; a pod deleted while its
    process runs gets SIGTERM, then SIGKILL after K8S_GRACE_S. preempt()
    SIGKILLs a pod's processes and reports exit code 137, reason
    Preempted."""

    def __init__(self, server, root, env):
        self._server = server
        self._root = root
        self._env = env
        self.procs = {}  # pod name -> Popen
        self.started = {}  # pod name -> time
        self.exited = {}  # pod name -> (exit code, time)
        self._preempted = set()
        self._deleted = {}  # pod name -> time SIGTERM was sent
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def log(self, name):
        return os.path.join(self._root, f"{name}.log")

    def _phase(self, name, phase, statuses=None):
        try:
            self._server.set_pod_phase(K8S_NS, name, phase, statuses)
        except KeyError:
            pass  # deleted meanwhile

    def _start(self, name, pod):
        container = pod["spec"]["containers"][0]
        command = list(container["command"])
        if command[0] == "python":
            command[0] = sys.executable
        env = dict(self._env)
        env.update({e["name"]: e["value"] for e in container.get("env", [])
                    if "value" in e})
        env["MY_POD_IP"] = "127.0.0.1"
        with open(self.log(name), "wb") as log:
            self.procs[name] = subprocess.Popen(
                command, cwd=REPO_DIR, env=env, stdout=log,
                stderr=subprocess.STDOUT, process_group=0)
        self.started[name] = time.time()
        self._phase(name, "Running")

    def _exit_status(self, name, rc):
        if name in self._preempted:
            code, reason = 137, "Preempted"
        else:
            code, reason = (rc if rc > 0 else 128 - rc), "Error"
        return [{"state": {"terminated": {"exitCode": code,
                                          "reason": reason}}}]

    def _loop(self):
        while not self._stop.is_set():
            pods = self._server.pods(K8S_NS)
            for name, pod in pods.items():
                if (name not in self.procs
                        and (pod.get("status") or {}).get("phase")
                        == "Pending"):
                    self._start(name, pod)
            now = time.time()
            for name, proc in list(self.procs.items()):
                if name in self.exited:
                    continue
                rc = proc.poll()
                if rc is None:
                    if name not in pods:
                        first = self._deleted.setdefault(name, now)
                        sig = (signal.SIGTERM if first == now else
                               signal.SIGKILL if now - first > K8S_GRACE_S
                               else None)
                        if sig is not None:
                            _killpg(proc, sig)
                    continue
                self.exited[name] = (rc, now)
                if rc == 0:
                    self._phase(name, "Succeeded")
                else:
                    self._phase(name, "Failed", self._exit_status(name, rc))
            self._stop.wait(0.02)

    def preempt(self, name):
        self._preempted.add(name)
        _killpg(self.procs[name], signal.SIGKILL)
        return time.time()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        for proc in self.procs.values():
            _killpg(proc, signal.SIGKILL)
            proc.wait(timeout=30)


def _killpg(proc, sig):
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass


def phase_k8s(results):
    """`edl train --instance_backend k8s` of the flagship against the fake
    API server, with a preempted worker pod."""
    sys.path.insert(0, os.path.join(REPO_DIR, "tests"))
    from fake_k8s_server import FakeK8sApiServer

    from elasticdl_tpu_torch.chaos import process as chaos_process

    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    layers = PROC_LAYERS
    torch.cuda.empty_cache()
    server = FakeK8sApiServer()
    kubelet = port = None
    logs = []
    master_pod = f"elasticdl-{K8S_JOB}-master"
    worker_pod = f"elasticdl-{K8S_JOB}-worker-0"
    with tempfile.TemporaryDirectory() as root:
        try:
            paths, _ = _write_job_inputs(root, proc_config(),
                                         n_train=K8S_RECORDS, n_valid=0)
            obs = os.path.join(root, "metrics")
            env = _proc_env(EDL_K8S_API_SERVER=server.endpoint,
                            ELASTICDL_OBS_DIR=obs)
            kubelet = _Kubelet(server, root, env)
            logs += [kubelet.log(master_pod), kubelet.log(worker_pod),
                     kubelet.log(worker_pod + "-r1")]
            start = time.time()
            submit = os.path.join(root, "submit.log")
            logs.append(submit)
            rc, submit_s, _ = _edl("train", [
                "--model_def", paths["model_def"],
                "--distribution_strategy", "Local",
                "--training_data", paths["train"],
                "--records_per_task", str(K8S_TASK), "--num_epochs", "1",
                "--minibatch_size", str(BATCH), "--log_loss_steps", "1",
                "--num_workers", "1", "--instance_backend", "k8s",
                "--image_name", "elasticdl_tpu_torch:card",
                "--job_name", K8S_JOB, "--master_port", "0",
                "--metrics_dir", obs, "--task_timeout_check_seconds", "1",
                "--seed", "0"], env, submit)
            if rc != 0:
                raise AssertionError(f"edl train (k8s) exited {rc}")
            _proc_wait(lambda: master_pod in kubelet.procs,
                       "the master pod's process")
            master = kubelet.procs[master_pod]
            port = _proc_port(kubelet.log(master_pod), master)
            status = _proc_status(port)
            _proc_wait(lambda: status().records_done >= K8S_TASK,
                       "the worker's first accepted report", master)
            kill = kubelet.preempt(worker_pod)
            _proc_wait(lambda: kubelet.exited.get(master_pod),
                       "the master pod's exit")
            _proc_wait(lambda: all(p.poll() is not None
                                   for p in kubelet.procs.values()),
                       "the pods' processes' exit")
            left = chaos_process.find_job_pids(port)
            wall_s = time.time() - start
            pods = {name: (pod.get("status") or {}).get("phase")
                    for name, pod in server.pods(K8S_NS).items()}
            services = sorted(server.services(K8S_NS))
        except BaseException:
            _print_log_tails(logs)
            raise
        finally:
            if kubelet is not None:
                kubelet.stop()
            server.stop()
        texts = {name: open(kubelet.log(name), errors="replace").read()
                 for name in kubelet.procs}
        spans = _trace_spans(obs, "worker-0")
        trains = [m for m in _jsonl(os.path.join(obs, "metrics.jsonl"))
                  if m["group"] == "train"]
        events = _jsonl(os.path.join(obs, "events.jsonl"))
    relaunched = worker_pod + "-r1"
    exits = {name: _exit_lines(text, "Worker").get("worker-0", [])
             for name, text in texts.items() if name != master_pod}
    k8s = {
        "submit_s": submit_s, "wall_s": wall_s,
        "timeline": sorted(
            (t, f"{name}: {label}") for name, text in texts.items()
            for t, label in _timeline(text, start)),
        "pods_started_at_s": {n: t - start
                              for n, t in kubelet.started.items()},
        "pods_exited": {n: (rc, t - start)
                        for n, (rc, t) in kubelet.exited.items()},
        "pod_phases_at_end": pods, "services": services,
        "kill_at_s": kill - start,
        "records_done": trains[-1]["records_done"] if trains else None,
        "pod_relaunch": [e["instance"] for e in events
                         if e["kind"] == "pod_relaunch"],
        "worker_exits": exits,
        "processes_left": len(left),
        "losses": [float(x) for x in re.findall(
            r"\) loss (\S+)", "".join(texts.values()))],
        # The relaunched pod's recovery: kill to its first accepted
        # report (its first get_task beside it).
        "kill_to_relaunched_pod_started_s": (
            kubelet.started.get(relaunched, math.inf) - kill),
        "kill_to_first_get_task_s": _first_after(spans, "/get_task", kill),
        "kill_to_first_report_s": _first_after(
            spans, "/report_task_result", kill, end=True, ok=True),
        "proc_lm_worker_kill_to_first_report_s": results["processes"][
            "proc_lm"]["worker_kill_to_first_report_s"],
    }
    emit({"phase": "k8s", **card, **k8s})
    steps = (K8S_RECORDS - K8S_TASK) // BATCH
    checks = [
        (k8s["records_done"] == K8S_RECORDS, "records_done"),
        (k8s["pod_relaunch"] == ["worker-0"], "worker 0 relaunched once"),
        (pods.get(master_pod) == "Succeeded", "the master pod Succeeded"),
        (sorted(kubelet.procs) == [master_pod, worker_pod, relaunched],
         "the pods the master created"),
        (kubelet.exited[master_pod][0] == 0
         and kubelet.exited[relaunched][0] == 0, "the pods' exit codes"),
        (f"tensorboard-{K8S_JOB}" in services, "the TensorBoard service"),
        (not left, "no process left"),
        (k8s["losses"] and all(math.isfinite(x) for x in k8s["losses"]),
         "finite losses"),
        (not exits[worker_pod] and len(exits[relaunched]) == 1
         and exits[relaunched][0]["steps"] == steps,
         "the relaunched pod trained the tasks left"),
        (_launch_check({relaunched: exits[relaunched]}, lambda e: {
            n: layers * e["steps"]
            for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}),
         "the relaunched pod's kernel launches"),
        (k8s["kill_to_first_report_s"] is not None,
         "the relaunched pod reported a task"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"k8s phase: {failed}")
    return k8s


# Elastic AllReduce (phase `allreduce`). ar_step, in this process: the
# flagship on AllReduceTrainer in a one-process world against LocalTrainer
# from the same weights (AR_STEPS steps on the main path's batches, bitwise),
# then two trainers as threads forming a gloo world of 2, each on half of
# the same batches of 4, against LocalTrainer at batch 4, then the MNIST CNN
# pulled by a joiner over the COLLECTIVE service. proc_ar, across
# processes: master.main with --multi_host and two worker processes on
# AR_RECORDS records in tasks of AR_TASK; worker 1 is SIGKILLed after the
# first lease of the world of 2, worker 0 goes on alone and is stopped
# after its first lease of the world of 1 (so that work is left when the
# relaunched worker 1 joins), and continued once worker 1 has registered.
AR_STEPS = 3
AR_DEVICE = "cuda"
AR_MNIST_BATCH = 4
AR_RECORDS = 192
AR_TASK = 16
AR_WORKERS = 2
# The two ranks against LocalTrainer at batch 4: the reference phase's
# bound, of each tensor's largest value, on the flagship with float32
# activations (see _ar_two_ranks).
AR_RTOL = 1e-4
AR_TWO_RANK_ACTIVATIONS = "float32"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ArControl:
    """The AllReduce part of the master service in this process: a
    membership behind an in-process stub."""

    def __init__(self):
        self.membership = MembershipManager(coordinator_port=_free_port())
        self.servicer = MasterServicer(TaskDispatcher({}), None,
                                       self.membership)

    def trainer(self, worker_id, make, **kw):
        model, loss_fn, opt = make()
        client = MasterClient(
            rpc.InProcessStub(self.servicer, rpc.MASTER_SERVICE), worker_id,
            worker_host="127.0.0.1")
        return AllReduceTrainer(model, loss_fn, opt, client,
                                device=AR_DEVICE, **kw)


def _lm_spec(activation_dtype=None):
    cfg = proc_config()
    if activation_dtype:
        cfg = dataclasses.replace(cfg, activation_dtype=activation_dtype)
    return lambda: (tlm.custom_model(cfg), tlm.loss, tlm.optimizer())


def _same_bits(a, b):
    """Two trainers' weights, buffers and optimizer leaves bit for bit."""
    sa, sb = a._model.state_dict(), b._model.state_dict()
    return list(sa) == list(sb) and all(
        torch.equal(sa[k], sb[k]) for k in sa) and all(
        torch.equal(x, y) for x, y in zip(a.optimizer_state_leaves(),
                                          b.optimizer_state_leaves()))


def _in_threads(*fns):
    """Each fn in a thread of its own; their results, or the first
    error."""
    out, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _ar_one_process(tokens):
    """AllReduceTrainer in a one-process world against LocalTrainer from
    the same seed: losses and every weight and optimizer leaf bitwise."""
    control = _ArControl()
    ar = control.trainer(0, _lm_spec())
    local = LocalTrainer(*_lm_spec()(), device=AR_DEVICE)
    losses, step_ms = [], []
    try:
        for i in range(AR_STEPS):
            rows = slice(i * BATCH, (i + 1) * BATCH)
            x, y = tokens[rows, :-1], tokens[rows, 1:]
            torch.cuda.synchronize()
            start = time.perf_counter()
            _, _, loss = ar.train_minibatch(x, y)
            losses.append(loss.item())
            step_ms.append(1e3 * (time.perf_counter() - start))
            _, _, local_loss = local.train_minibatch(x, y)
            if not torch.equal(loss, local_loss):
                raise AssertionError(
                    f"step {i}: loss {loss.item()} != LocalTrainer's "
                    f"{local_loss.item()}")
        bitwise = _same_bits(ar, local)
        spec = ar.world_fingerprint
    finally:
        ar.close()
    if not bitwise:
        raise AssertionError("the one-process world's weights differ from "
                             "LocalTrainer's")
    return {"losses": losses, "step_ms": step_ms, "spec": spec,
            "bitwise_with_local_trainer": bitwise}


def _adam_bound(ref, grad1):
    """Per element: AR_RTOL of the tensor's largest value, plus the
    documented Adam term for an element whose gradient is rounding noise
    (ROADMAP Queue 3: up to the learning rate per step either way),
    lr * noise * eps / (|g| + eps)^2 per step with noise the gradient
    tolerance AR_RTOL * max|g| and g the first step's gradient."""
    spec = tlm.optimizer().hyperparams
    lr, eps = spec["learning_rate"], spec["epsilon"]
    noise = AR_RTOL * grad1.abs().max()
    adam = torch.minimum(torch.full_like(grad1, 2 * lr),
                         lr * noise * eps / (grad1.abs() + eps) ** 2)
    return AR_RTOL * ref.abs().max() + AR_STEPS * adam


def _ar_two_ranks(tokens):
    """Two trainers as threads on the card, a gloo world of 2, each on
    half of each batch of 4, against LocalTrainer at batch 4. The model is
    the flagship with float32 activations: with bfloat16 ones each rank's
    weight gradients are rounded to bfloat16 before the all-reduce, and
    the sum of two rounded halves differs from the rounded whole by up to
    a bfloat16 ulp (4e-3 of the largest gradient in the CPU rehearsal), so
    no 1e-4 bound could hold there; _ar_two_ranks_bf16 holds the bfloat16
    flagship's averaged gradients, the ones proc_ar trains with."""
    control = _ArControl()
    spec = _lm_spec(AR_TWO_RANK_ACTIVATIONS)
    ranks = [control.trainer(i, spec, multi_host=True)
             for i in range(AR_WORKERS)]
    for t in ranks:
        t._mc.report_liveness()
    local = LocalTrainer(*spec(), device=AR_DEVICE)
    half = BATCH // AR_WORKERS
    out = {"losses": [], "local_losses": [], "step_ms": [], "comm": []}
    grad_err = None
    try:
        # The world forms first: the join gate, the rendezvous and the
        # state sync from rank 0 (every weight and Adam moment).
        start = time.perf_counter()
        _in_threads(*[(lambda t=t: t.init_variables_if_needed(
            tokens[:half, :-1])) for t in ranks])
        out["form_world_ms"] = 1e3 * (time.perf_counter() - start)
        out["sync"] = ranks[1].world.stats.as_dict()
        for i in range(AR_STEPS):
            rows = tokens[i * BATCH:(i + 1) * BATCH]
            for t in ranks:
                t.world.stats.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses = _in_threads(*[
                (lambda t=t, r=r: t.train_minibatch(
                    rows[r * half:(r + 1) * half, :-1],
                    rows[r * half:(r + 1) * half, 1:])[2])
                for r, t in enumerate(ranks)])
            values = [loss.item() for loss in losses]
            out["step_ms"].append(1e3 * (time.perf_counter() - start))
            out["comm"].append(ranks[0].world.stats.as_dict())
            if not torch.equal(losses[0], losses[1]):
                raise AssertionError(f"step {i}: the ranks' losses differ")
            _, _, local_loss = local.train_minibatch(rows[:, :-1],
                                                     rows[:, 1:])
            out["losses"].append(values[0])
            out["local_losses"].append(local_loss.item())
            if i == 0:
                # The averaged gradients of the first step against the
                # whole batch's; kept for the Adam bound below.
                grad1 = {n: p.grad.detach().clone() for n, p in
                         local._model.named_parameters()}
                grad_err = max(
                    float((p.grad - grad1[n]).abs().max()
                          / grad1[n].abs().max().clamp_min(1e-30))
                    for n, p in ranks[0]._model.named_parameters())
        bitwise = _same_bits(ranks[0], ranks[1])
        worst, beyond, plain = None, 0, 0.0
        ref = dict(local._model.named_parameters())
        for n, p in ranks[0]._model.named_parameters():
            diff = (p.detach() - ref[n].detach()).abs()
            rel = float(diff.max()
                        / ref[n].detach().abs().max().clamp_min(1e-30))
            if worst is None or rel > plain:
                worst, plain = n, rel
            beyond += int((diff > _adam_bound(ref[n].detach(),
                                              grad1[n])).sum())
        spec = ranks[0].world_fingerprint
    finally:
        for t in ranks:
            t.close()
    comm = {k: float(np.mean([c[k] for c in out["comm"]]))
            for k in ("d2h_s", "gloo_s", "h2d_s", "bytes", "calls")}
    result = {
        **out, "spec": spec, "backend": "gloo",
        "ranks_bitwise": bitwise,
        "first_step_grad_max_rel_err": grad_err,
        "param_max_rel_err": plain, "param_worst": worst,
        "params_beyond_bound": beyond,
        "allreduce_per_step": {
            "d2h_ms": 1e3 * comm["d2h_s"], "gloo_ms": 1e3 * comm["gloo_s"],
            "h2d_ms": 1e3 * comm["h2d_s"], "bytes": comm["bytes"],
            "buckets": comm["calls"]},
    }
    checks = [
        (bitwise, "the ranks' weights and optimizer leaves bitwise"),
        (grad_err is not None and grad_err <= AR_RTOL,
         "the first step's averaged gradients"),
        (beyond == 0, "the ranks' weights against LocalTrainer at batch 4"),
        (all(abs(a - b) <= 1e-5 * abs(b) for a, b in
             zip(out["losses"], out["local_losses"])), "the losses"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        emit({"phase": "allreduce", "run": "two_ranks", **result})
        raise AssertionError(f"two-rank world: {failed}")
    return result


def _ar_two_ranks_bf16(tokens):
    """The bfloat16 flagship, as users and proc_ar train it, as two ranks
    at batch 2 for one step. Each rank's step is LocalTrainer's at batch 2
    (the one-process world shows it bit for bit), so the averaged
    gradients and the loss must equal, bit for bit, the mean of two
    LocalTrainers' on the two halves, summed and then divided by the world
    size as the all-reduce does: a missing divide, or a bucket summed twice
    or left out, breaks that. Against LocalTrainer at batch 4 the
    gradients differ by bfloat16 noise (other GEMM shapes round
    otherwise), reported and not bounded. The ranks' weights and optimizer
    leaves bitwise."""
    spec = _lm_spec()
    half = BATCH // AR_WORKERS
    rows = tokens[:BATCH]
    parts = [(rows[r * half:(r + 1) * half, :-1],
              rows[r * half:(r + 1) * half, 1:]) for r in range(AR_WORKERS)]

    def local_step(x, y):
        local = LocalTrainer(*spec(), device=AR_DEVICE)
        _, _, loss = local.train_minibatch(x, y)
        return loss, {n: p.grad.detach().clone()
                      for n, p in local._model.named_parameters()}

    mean_loss, mean = local_step(*parts[0])
    for x, y in parts[1:]:
        loss, grads = local_step(x, y)
        mean_loss = mean_loss + loss
        torch._foreach_add_(list(mean.values()), list(grads.values()))
        del grads
    mean_loss = mean_loss / AR_WORKERS
    torch._foreach_div_(list(mean.values()), AR_WORKERS)
    whole_loss, whole = local_step(rows[:, :-1], rows[:, 1:])
    gc.collect()
    torch.cuda.empty_cache()
    control = _ArControl()
    ranks = [control.trainer(i, spec, multi_host=True)
             for i in range(AR_WORKERS)]
    for t in ranks:
        t._mc.report_liveness()
    try:
        _in_threads(*[(lambda t=t: t.init_variables_if_needed(
            parts[0][0])) for t in ranks])
        torch.cuda.synchronize()
        start = time.perf_counter()
        losses = _in_threads(*[
            (lambda t=t, r=r: t.train_minibatch(*parts[r])[2])
            for r, t in enumerate(ranks)])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - start)
        got = dict(ranks[0]._model.named_parameters())
        differ = [n for n in mean if not torch.equal(got[n].grad, mean[n])]
        errs = {n: float((got[n].grad - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for n, g in whole.items()}
        bitwise = _same_bits(ranks[0], ranks[1])
    finally:
        for t in ranks:
            t.close()
    worst = max(errs, key=errs.get)
    result = {"activations": "bfloat16", "backend": "gloo",
              "step_ms": step_ms, "loss": losses[0].item(),
              "halves_mean_loss": mean_loss.item(),
              "whole_batch_loss": whole_loss.item(),
              "grads_differing_from_halves_mean": differ,
              "whole_batch_grad_max_rel_err": errs[worst],
              "whole_batch_grad_worst": worst, "ranks_bitwise": bitwise}
    if differ or not (bitwise and torch.equal(losses[0], mean_loss)
                      and torch.equal(losses[0], losses[1])):
        emit({"phase": "allreduce", "run": "two_ranks_bf16", **result})
        raise AssertionError("two-rank bfloat16 world: the averaged "
                             "gradients or loss, or the ranks' bits")
    return result


def _ar_mnist_pull():
    """Two one-process worlds of the MNIST CNN: a joiner pulls rank 0's
    variables, BatchNorm statistics, optimizer leaves and version over the
    COLLECTIVE service."""
    rng = np.random.default_rng(0)
    x = rng.random((AR_MNIST_BATCH, 28, 28), np.float32)
    y = rng.integers(0, 10, AR_MNIST_BATCH).astype(np.int64)

    def make():
        return (mnist_model.custom_model(), mnist_model.loss,
                mnist_model.optimizer())

    control = _ArControl()
    first = control.trainer(0, make)
    joiner = None
    try:
        for _ in range(2):
            first.train_minibatch(x, y)
        joiner = control.trainer(1, make, seed=5)
        start = time.perf_counter()
        joiner.init_variables_if_needed(x)
        pull_ms = 1e3 * (time.perf_counter() - start)
        a, b = first.export_variables(), joiner.export_variables()
        bitwise = (
            a["version"] == b["version"] == 2
            and all(np.array_equal(a["variables"][k], b["variables"][k])
                    for k in a["variables"])
            and set(a["state"]) == set(b["state"])
            and all(np.array_equal(a["state"][k], b["state"][k])
                    for k in a["state"])
            and all(torch.equal(p, q) for p, q in
                    zip(a["opt_state"], b["opt_state"])))
        rank = joiner.rank
    finally:
        first.close()
        if joiner is not None:
            joiner.close()
    if not (bitwise and rank == 1):
        raise AssertionError("the joiner's pulled MNIST state differs")
    return {"bitwise": bitwise, "batch_stats": sorted(a["state"]),
            "init_and_pull_ms": pull_ms}


_AR_MARKS = (
    ("model_built", r"Initialized model"),
    ("world_change", r"World change: epoch (-?\d+) -> (\d+) \(rank (\d+) "
                     r"of (\d+)\)"),
    ("joining", r"Joining world .* size=(\d+) rank=(\d+) epoch=(\d+)"),
    ("synced", r"Collective state sync complete \(version (\d+), source "
               r"rank 0, this rank (\d+)\)"),
    ("step", r"Step \d+ \(lease (\d+)\) loss (\S+)"),
    ("minted", r"Minted lease (\d+): epoch (\d+), world (\d+)"),
    ("relaunching", r"Relaunching worker (\d+)"),
)


def _log_marks(text):
    """[(wall time, mark, groups)] of the job log's lines that _AR_MARKS
    name, in order (log times are the host's local clock, to the
    millisecond)."""
    out = []
    for line in text.splitlines():
        stamp = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]",
                         line)
        if not stamp:
            continue
        for name, pattern in _AR_MARKS:
            found = re.search(pattern, line)
            if found:
                t = time.mktime(time.strptime(stamp.group(1),
                                              "%Y-%m-%d %H:%M:%S"))
                out.append((t + int(stamp.group(2)) / 1e3, name,
                            found.groups()))
                break
    return out


def _events_since(path, since, kind, **match):
    if not os.path.exists(path):
        return []
    return [e for e in _jsonl(path) if e["kind"] == kind and e["ts"] > since
            and all(e.get(k) == v for k, v in match.items())]


def _ms_per_step_by_world(marks):
    """Median ms per step of each world size, from the logged steps of
    its leases: within a lease, the time from one rank's step to its next
    (the ranks of a world step in lockstep, so a lease's step lines come
    `world` at a time)."""
    world_of = {int(g[0]): int(g[2]) for _, name, g in marks
                if name == "minted"}
    by_lease = {}
    for t, name, g in marks:
        if name == "step":
            by_lease.setdefault(int(g[0]), []).append(t)
    out = {}
    for lease, times in by_lease.items():
        world = world_of.get(lease, 1)
        times = sorted(times)
        out.setdefault(world, []).extend(
            1e3 * (b - a) for a, b in zip(times, times[world:]))
    return {f"world_{w}": float(np.median(v))
            for w, v in sorted(out.items()) if v}


def _proc_ar(root):
    """The flagship as a --multi_host AllReduce job across processes with
    a worker kill and rejoin; returns the times and the checks' inputs."""
    from elasticdl_tpu_torch.chaos import process as chaos_process

    cfg = proc_config()
    paths, _ = _write_job_inputs(root, cfg, n_train=AR_RECORDS, n_valid=0)
    obs = os.path.join(root, "metrics")
    events = os.path.join(obs, "events.jsonl")
    argv = ["--model_def", paths["model_def"],
            "--distribution_strategy", "AllreduceStrategy", "--multi_host",
            "--training_data", paths["train"],
            "--records_per_task", str(AR_TASK), "--num_epochs", "1",
            "--minibatch_size", str(BATCH),
            "--log_loss_steps", "1", "--metrics_dir", obs,
            "--job_name", "proc-ar", "--task_timeout_check_seconds", "1",
            "--seed", "0", "--instance_backend", "local_process",
            "--num_workers", str(AR_WORKERS), "--master_port", "0",
            "--coordinator_port", str(_free_port())]
    log = os.path.join(root, "master.log")
    start = time.time()
    master = _proc_master(argv, _proc_env(), log)
    port = stopped = None
    try:
        port = _proc_port(log, master)
        _proc_wait(lambda: _events_since(events, 0, "lease_complete",
                                         world=AR_WORKERS),
                   "the first lease of the world of 2", master)
        worker_kill = time.time()
        chaos_process.kill_role("worker", 1, port, timeout=PROC_TIMEOUT)
        alone = _proc_wait(lambda: _events_since(
            events, worker_kill, "lease_complete", world=1),
            "worker 0's first lease alone", master)[0]["ts"]
        # Worker 0 would finish the job alone before the relaunched worker
        # 1 is up (a flagship process needs ~20 s): stop it until worker 1
        # has registered, then continue it.
        stopped = chaos_process.find_role_pid("worker", 0, port,
                                              timeout=PROC_TIMEOUT)
        chaos_process.deliver(stopped, signal.SIGSTOP)
        stopped_at = time.time()
        joined = _proc_wait(lambda: _events_since(
            events, worker_kill, "membership_epoch", cause="join"),
            "the relaunched worker 1's registration", master)[0]["ts"]
        chaos_process.deliver(stopped, signal.SIGCONT)
        continued = time.time()
        stopped = None
        rc = master.wait(timeout=PROC_TIMEOUT)
        _proc_wait(lambda: not chaos_process.find_job_pids(port),
                   "the workers' exit")
        wall_s = time.time() - start
    except BaseException:
        if stopped is not None:
            chaos_process.deliver(stopped, signal.SIGCONT)
        _print_log_tails([log])
        raise
    finally:
        _proc_teardown((master,), port)
    left = chaos_process.find_job_pids(port)
    text = open(log, errors="replace").read()
    marks = _log_marks(text)
    all_events = _jsonl(events)
    relaunch = next(e["ts"] for e in all_events
                    if e["kind"] == "pod_relaunch")
    after = [(t, name, g) for t, name, g in marks if t > relaunch]
    built = next(t for t, name, _ in after if name == "model_built")
    gate = next(t for t, name, g in after
                if name == "world_change" and g[2:] == ("1", "2"))
    joining = next(t for t, name, g in after
                   if name == "joining" and g[1] == "1")
    synced = next(t for t, name, g in after
                  if name == "synced" and g[1] == "1")
    rejoined = next(e["ts"] for e in all_events
                    if e["kind"] == "lease_complete" and e["ts"] > synced
                    and e["world"] == AR_WORKERS)
    minted = {e["lease_id"]: e for e in all_events
              if e["kind"] == "lease_mint"}
    completed = [e["lease_id"] for e in all_events
                 if e["kind"] == "lease_complete"]
    aborted = [e["lease_id"] for e in all_events
               if e["kind"] == "lease_abort"]
    trains = [m for m in _jsonl(os.path.join(obs, "metrics.jsonl"))
              if m["group"] == "train"]
    return {
        "master_rc": rc, "wall_s": wall_s, "left": left,
        "records_done": trains[-1]["records_done"] if trains else None,
        "pod_relaunch": [e["instance"] for e in all_events
                         if e["kind"] == "pod_relaunch"],
        "membership_epochs": [e["epoch"] for e in all_events
                              if e["kind"] == "membership_epoch"],
        "regroups": [(e.get("role"), e["mode"], e["epoch"],
                      e["world_size"]) for e in all_events
                     if e["kind"] == "elastic_regroup"],
        "leases": {"minted": len(minted), "completed": completed,
                   "aborted": aborted,
                   "completed_records": sum(minted[i]["records"]
                                            for i in completed)},
        "losses": [float(g[1]) for _, name, g in marks if name == "step"],
        "ms_per_step": _ms_per_step_by_world(marks),
        "worker_exits": _exit_lines(text, "Worker"),
        "worker_kill_to_alone_lease_s": alone - worker_kill,
        "worker_0_stopped_s": continued - stopped_at,
        "worker_kill_to_relaunch_s": relaunch - worker_kill,
        "relaunch_to_registered_s": joined - relaunch,
        "relaunch_to_rejoined_lease_s": rejoined - relaunch,
        "rejoin_split_s": {
            "process_start_and_model": built - relaunch,
            "to_join_gate": gate - built,
            "join_gate": joining - gate,
            "rendezvous_and_state_sync": synced - joining,
            "to_first_lease_complete": rejoined - synced,
        },
    }


def phase_allreduce(results):
    """Elastic AllReduce on the card: in process (one-process world, a
    gloo world of 2 as threads, the MNIST pull), then across processes
    with a worker kill and rejoin."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    cfg = proc_config()
    tokens = synthetic_lm_tokens(4 * BATCH, SEQ, vocab=cfg.vocab,
                                 branching=4, seed=0)
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    single = _ar_one_process(tokens)
    emit({"phase": "allreduce", "run": "one_process_world", **card,
          **single})
    gc.collect()
    torch.cuda.empty_cache()
    two = _ar_two_ranks(tokens)
    emit({"phase": "allreduce", "run": "two_ranks", **card,
          "proc_lm_ms_per_step_shared": results["processes"]["proc_lm"][
              "ms_per_step_by_worker"], **two})
    gc.collect()
    torch.cuda.empty_cache()
    two_bf16 = _ar_two_ranks_bf16(tokens)
    launches = dict(fa.launches)
    emit({"phase": "allreduce", "run": "two_ranks_bf16", **card,
          **two_bf16})
    # 3 steps each of: the one-process world, its LocalTrainer, two ranks
    # and their LocalTrainer; one step each of the bfloat16 ranks, the two
    # LocalTrainers of their halves and the one of the whole batch; no
    # evaluation.
    steps = AR_STEPS * (2 + AR_WORKERS + 1) + 2 * AR_WORKERS + 1
    expected = {n: cfg.n_layers * steps
                for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"ar_step launches {launches}, expected "
                             f"{expected}")
    gc.collect()
    torch.cuda.empty_cache()
    pull = _ar_mnist_pull()
    emit({"phase": "allreduce", "run": "mnist_pull", **card, **pull})
    with tempfile.TemporaryDirectory() as root:
        proc = _proc_ar(root)
    emit({"phase": "allreduce", "run": "proc_ar", **card, **proc})
    exits = proc["worker_exits"]
    last = [v[-1] for v in exits.values()]
    checks = [
        (proc["master_rc"] == 0, "the master's exit code"),
        (proc["records_done"] == AR_RECORDS, "records_done"),
        (proc["leases"]["completed_records"] == AR_RECORDS
         and proc["leases"]["minted"] == len(proc["leases"]["completed"])
         + len(proc["leases"]["aborted"]),
         "every record in one completed lease, the rest aborted"),
        (proc["pod_relaunch"] == ["worker-1"], "worker 1 relaunched once"),
        (proc["membership_epochs"] == sorted(set(
            proc["membership_epochs"])), "membership epochs increasing"),
        (not proc["left"], "no process left"),
        (proc["losses"] and all(math.isfinite(x) for x in proc["losses"]),
         "finite losses"),
        (sorted(exits) == [f"worker-{i}" for i in range(AR_WORKERS)]
         and all(len(v) == 1 for v in exits.values()),
         "one exit line per worker id (worker 1's first process killed)"),
        # A step cut by the peer's death ran its forward and backward
        # before its all-reduce raised: its launches count, its step not.
        (_launch_check(exits, lambda e: {
            n: PROC_LAYERS * (e["steps"] + e["failed_steps"])
            for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}),
         "each rank process's kernel launches"),
        (len({(e["version"], e["digest"]) for e in last}) == 1
         and last[0]["digest"], "the last world's version and digest"),
    ]
    failed = [what for ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"allreduce phase: {failed}")
    return {"launches": launches, "one_process_world": single,
            "two_ranks": two, "two_ranks_bf16": two_bf16,
            "mnist_pull": pull, "proc_ar": proc}


# ---------- the model and seq axes: shards of one process on the card ----------

# The bounded checks: one step of each configuration with float32
# activations against LocalTrainer from the same seed and batch (the
# flagship's widths at MA_CHECK_LAYERS layers); loss and every gathered
# gradient within MA_RTOL of the tensor's largest value: f32 partial sums
# in another order. (name, trainer options, shards per process).
MA_CHECK_LAYERS = 4
MA_RTOL = 1e-4
MA_CHECKS = (
    ("tp2", dict(model_parallel_size=2), 2),
    ("sp2_zigzag", dict(context_parallel_size=2), 2),
    ("sp2_ring", dict(context_parallel_size=2,
                      context_parallel_impl="ring"), 2),
    ("sp2_ulysses", dict(context_parallel_size=2,
                         context_parallel_impl="ulysses"), 2),
    ("tp2_sp2_zigzag", dict(model_parallel_size=2,
                            context_parallel_size=2), 4),
)
# The timed runs: the bfloat16 flagship (full depth), MA_STEPS steps each.
MA_TIMED = (("tp2", dict(model_parallel_size=2), 2),
            ("sp2_zigzag", dict(context_parallel_size=2), 2))
MA_STEPS = 1
# One job through the entry points: two worker processes of two model
# shards each sharing the card, the bfloat16 flagship at PROC_LAYERS.
MA_JOB_RECORDS = 32
MA_JOB_TASK = 16
MA_JOB_WORKERS = 2


def _ma_blocks(kw, seq_coord):
    """Flash-attention blocks a shard runs per layer and step (each a
    forward, a dQ and a dK/dV launch): one without a seq axis and under
    Ulysses, 2N+1 half-blocks under zigzag, the blocks at or below the
    diagonal under the causal ring."""
    sp = kw.get("context_parallel_size", 1)
    impl = kw.get("context_parallel_impl", "zigzag")
    if sp == 1 or impl == "ulysses":
        return 1
    return 2 * sp + 1 if impl == "zigzag" else seq_coord + 1


def _ma_trainer(kw, shards, cfg, spec=tlm):
    """An AllReduceTrainer of one process with `shards` shards sharing the
    card (ELASTICDL_LOCAL_DEVICES), its model spec's hooks bound to
    cfg."""
    hooks = {"param_specs_fn": spec.param_specs}
    if spec is tlm:
        hooks["context_parallel_model_fn"] = functools.partial(
            tlm.context_parallel_model, config=cfg)
    with _environ(ELASTICDL_LOCAL_DEVICES=str(shards)):
        return _ArControl().trainer(
            0, lambda: (spec.custom_model(cfg), spec.loss,
                        spec.optimizer()), **hooks, **kw)


def _flax_grads(model):
    return {x.name: x.to_flax(x.param.grad).detach().clone()
            for x in flax_leaves(model)}


def _ma_errors(trainer, loss, ref_loss, ref_grads):
    grads = _flax_grads(trainer._model)
    errors = {n: float((grads[n] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)) for n, g in ref_grads.items()}
    errors["loss"] = abs(float(loss) - ref_loss) / abs(ref_loss)
    return errors


def _ma_launch_check(trainer, kw, layers, steps):
    """Each shard's launches against the schedule's count."""
    want, got = [], []
    for i, counts in enumerate(trainer.shard_launches):
        blocks = _ma_blocks(kw, trainer.shards.layout.coords(i)["seq"])
        want.append({n: blocks * layers * steps
                     for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")})
        got.append({k: v for k, v in counts.items() if v})
    return got, want


def _ma_f32_checks(x, y):
    cfg = dataclasses.replace(tlm.flagship_config(SEQ),
                              n_layers=MA_CHECK_LAYERS,
                              activation_dtype="float32")
    local = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                         device=AR_DEVICE)
    _, _, ref_loss = local.train_minibatch(x, y)
    ref_loss = ref_loss.item()
    ref_grads = _flax_grads(local._model)
    del local
    out = {}
    for name, kw, shards in MA_CHECKS:
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _ma_trainer(kw, shards, cfg)
        try:
            _, _, loss = trainer.train_minibatch(x, y)
            torch.cuda.synchronize()
            errors = _ma_errors(trainer, loss, ref_loss, ref_grads)
            got, want = _ma_launch_check(trainer, kw, cfg.n_layers, 1)
            out[name] = {"spec": trainer.world_fingerprint,
                         "loss": loss.item(), "local_loss": ref_loss,
                         "max_rel_err": max(errors.values()),
                         "worst": max(errors, key=errors.get),
                         "shard_launches": got}
        finally:
            trainer.close()
        bad = {k: v for k, v in errors.items() if not v <= MA_RTOL}
        if bad or got != want:
            raise AssertionError(f"model_axes {name}: errors over "
                                 f"{MA_RTOL} {bad}; launches {got}, "
                                 f"expected {want}")
    return out


def _ma_moe_check(x, y):
    """The Switch-MoE LM (flagship widths, MA_CHECK_LAYERS layers, float32)
    over two model shards of 2 experts each: every MoE layer's routing on
    each shard equal to LocalTrainer's (expert and keep, from each side's
    own layer input), then the loss with its aux term and every gradient
    within MA_RTOL."""
    cfg = dataclasses.replace(moe_lm.flagship_config(SEQ),
                              n_layers=MA_CHECK_LAYERS,
                              activation_dtype="float32")

    def capture(model, cls):
        """Each `cls` layer's routing of its own input, as it runs."""
        routes = []

        def hook(mod, args):
            with torch.no_grad():
                routes.append(moe_layer.route(mod, args[0]))

        for m in model.modules():
            if isinstance(m, cls):
                m.register_forward_pre_hook(hook)
        return routes

    local = LocalTrainer(moe_lm.custom_model(cfg), moe_lm.loss,
                         moe_lm.optimizer(), device=AR_DEVICE)
    local.init_variables_if_needed(x)
    want_routes = capture(local._model, moe_layer.SwitchMoE)
    _, _, ref_loss = local.train_minibatch(x, y)
    ref_grads = _flax_grads(local._model)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(model_parallel_size=2)
    trainer = _ma_trainer(kw, 2, cfg, spec=moe_lm)
    try:
        trainer.init_variables_if_needed(x)
        captured = [capture(m, moe_layer.ExpertParallelMoE)
                    for m in trainer.shards.models]
        _, _, loss = trainer.train_minibatch(x, y)
        torch.cuda.synchronize()
        routing = []
        for shard, got_routes in enumerate(captured):
            for layer, (got, want) in enumerate(zip(got_routes,
                                                    want_routes)):
                differ = ((got.expert != want.expert)
                          | (got.keep != want.keep))
                routing.append({"shard": shard, "layer": layer,
                                "tokens": int(want.expert.numel()),
                                "kept": int(want.keep.sum()),
                                "tokens_differ": int(differ.sum())})
        if any(r["tokens_differ"] for r in routing) or len(routing) != 2 * (
                cfg.n_layers // cfg.moe_every):
            raise AssertionError(f"model_axes moe_ep2 routing: {routing}")
        errors = _ma_errors(trainer, loss, ref_loss.item(), ref_grads)
        got, want = _ma_launch_check(trainer, kw, cfg.n_layers, 1)
        result = {"spec": trainer.world_fingerprint, "routing": routing,
                  "loss": loss.item(), "local_loss": ref_loss.item(),
                  "max_rel_err": max(errors.values()),
                  "worst": max(errors, key=errors.get),
                  "shard_launches": got,
                  "experts_per_shard": [m.w_in.shape[0] for m in
                                        trainer.shards.models[0].modules()
                                        if isinstance(
                                            m, moe_layer.ExpertParallelMoE)]}
    finally:
        trainer.close()
    bad = {k: v for k, v in errors.items() if not v <= MA_RTOL}
    if bad or got != want:
        raise AssertionError(f"model_axes moe_ep2: errors {bad}; launches "
                             f"{got}, expected {want}")
    return result


def _timed_steps(trainer, batches):
    """The trainer built, its gloo counters and shard launches cleared,
    then a step per batch: the losses, ms per step (host clock, each step
    ending in the loss's copy to the host) and the peak memory."""
    trainer.init_variables_if_needed(batches[0][0])
    for stats in getattr(trainer, "axis_stats", {}).values():
        stats.reset()
    for counts in getattr(trainer, "shard_launches", []):
        counts.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for x, y in batches:
        start = time.perf_counter()
        _, _, loss = trainer.train_minibatch(x, y)
        losses.append(loss.item())
        ms.append(1e3 * (time.perf_counter() - start))
    return {"losses": losses, "ms_per_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _ma_timed(tokens):
    """The bfloat16 flagship: LocalTrainer, then each MA_TIMED world,
    MA_STEPS steps each on the same batches: ms per step, the gloo legs per
    axis, peak memory, the losses beside LocalTrainer's."""
    cfg = tlm.flagship_config(SEQ)
    batches = [(tokens[i * BATCH:(i + 1) * BATCH, :-1],
                tokens[i * BATCH:(i + 1) * BATCH, 1:])
               for i in range(MA_STEPS)]

    run = functools.partial(_timed_steps, batches=batches)
    local = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                         device=AR_DEVICE)
    out = {"local": run(local)}
    del local
    for name, kw, shards in MA_TIMED:
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _ma_trainer(kw, shards, cfg)
        try:
            out[name] = run(trainer)
            got, want = _ma_launch_check(trainer, kw, cfg.n_layers,
                                         MA_STEPS)
            out[name].update(
                spec=trainer.world_fingerprint, shard_launches=got,
                gloo={axis: s.as_dict()
                      for axis, s in trainer.axis_stats.items()})
        finally:
            trainer.close()
        if got != want:
            raise AssertionError(f"model_axes timed {name}: launches {got}, "
                                 f"expected {want}")
    return out


def _allreduce_job(root, name, flags, records, task, workers):
    """A --multi_host AllReduceStrategy job through master.main with
    `workers` worker processes of two shards each on the card
    (ELASTICDL_LOCAL_DEVICES=2), the bfloat16 flagship at PROC_LAYERS,
    `records` training records in tasks of `task`, and `flags` added."""
    cfg = proc_config()
    paths, _ = _write_job_inputs(root, cfg, n_train=records, n_valid=0)
    obs = os.path.join(root, "metrics")
    argv = ["--model_def", paths["model_def"],
            "--distribution_strategy", "AllreduceStrategy", "--multi_host",
            *flags,
            "--training_data", paths["train"],
            "--records_per_task", str(task), "--num_epochs", "1",
            "--minibatch_size", str(BATCH), "--log_loss_steps", "1",
            "--metrics_dir", obs, "--job_name", name,
            "--seed", "0", "--instance_backend", "local_process",
            "--num_workers", str(workers), "--master_port", "0",
            "--coordinator_port", str(_free_port())]
    log = os.path.join(root, "master.log")
    start = time.time()
    master = _proc_master(argv, _proc_env(ELASTICDL_LOCAL_DEVICES="2"), log)
    port = None
    try:
        port = _proc_port(log, master)
        rc = master.wait(timeout=PROC_TIMEOUT)
        _proc_wait(lambda: not _job_pids(port), "the workers' exit")
        wall_s = time.time() - start
    except BaseException:
        _print_log_tails([log])
        raise
    finally:
        _proc_teardown((master,), port)
    left = _job_pids(port)
    text = open(log, errors="replace").read()
    marks = _log_marks(text)
    trains = [m for m in _jsonl(os.path.join(obs, "metrics.jsonl"))
              if m["group"] == "train"]
    exits = _exit_lines(text, "Worker")
    return {"master_rc": rc, "wall_s": wall_s, "left": left,
            "records_done": trains[-1]["records_done"] if trains else None,
            "losses": [float(g[1]) for _, n, g in marks if n == "step"],
            "ms_per_step": _ms_per_step_by_world(marks),
            "world_specs": sorted(set(re.findall(
                r"World spec (\S+):", text))),
            "pipelined_inits": re.findall(
                r"Initialized pipelined model with \d+ parameters "
                r"\((\d+) stage rows, schedule (\S+)\)", text),
            "worker_exits": exits}


def _ma_job(root):
    """--multi_host --model_parallel_size 2 through master.main with two
    worker processes of two model shards each, all on the card."""
    return _allreduce_job(root, "model-axes", ["--model_parallel_size", "2"],
                          MA_JOB_RECORDS, MA_JOB_TASK, MA_JOB_WORKERS)


def _job_pids(port):
    """The processes that still carry the job's master address."""
    from elasticdl_tpu_torch.chaos import process as chaos_process

    return chaos_process.find_job_pids(port)


def phase_model_axes(results):
    """The model and seq axes on the card: the float32 checks of TP2, SP2
    (zigzag, ring, Ulysses), TP2 x SP2 and the MoE LM's EP2 against
    LocalTrainer; the bfloat16 flagship timed under TP2 and SP2 zigzag;
    then a two-process TP2 job through master.main."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    tokens = synthetic_lm_tokens(MA_STEPS * BATCH, SEQ, vocab=32768,
                                 branching=4, seed=0)
    x, y = tokens[:BATCH, :-1], tokens[:BATCH, 1:]
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    start = time.perf_counter()
    checks = _ma_f32_checks(x, y)
    emit({"phase": "model_axes", "run": "f32_checks", **card,
          "seconds": time.perf_counter() - start, "tolerance": MA_RTOL,
          "layers": MA_CHECK_LAYERS, **checks})
    gc.collect()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    moe = _ma_moe_check(x, y)
    emit({"phase": "model_axes", "run": "moe_ep2", **card,
          "seconds": time.perf_counter() - start, **moe})
    gc.collect()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    timed = _ma_timed(tokens)
    emit({"phase": "model_axes", "run": "timed_bf16", **card,
          "seconds": time.perf_counter() - start, **timed})
    with tempfile.TemporaryDirectory() as root:
        job = _ma_job(root)
    emit({"phase": "model_axes", "run": "tp2_job", **card, **job})
    exits = job["worker_exits"]
    last = [v[-1] for v in exits.values()]
    per_step = {n: 2 * PROC_LAYERS
                for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
    checks_ok = [
        (job["master_rc"] == 0, "the master's exit code"),
        (job["records_done"] == MA_JOB_RECORDS, "records_done"),
        (not job["left"], "no process left"),
        (job["losses"] and all(math.isfinite(v) for v in job["losses"]),
         "finite losses"),
        (sorted(exits) == [f"worker-{i}" for i in range(MA_JOB_WORKERS)],
         "one exit line per worker"),
        (_launch_check(exits, lambda e: {
            n: c * (e["steps"] + e["failed_steps"])
            for n, c in per_step.items()}),
         "each process's launches: 2 shards x layers per step"),
        (all(e["spec"].startswith("data=") and "model=2" in e["spec"]
             for e in last), "TP2 worlds"),
        (len({(e["version"], e["digest"]) for e in last}) == 1
         and last[0]["digest"], "equal version and digest"),
    ]
    failed = [what for ok, what in checks_ok if not ok]
    if failed:
        raise AssertionError(f"model_axes tp2_job: {failed}")
    return {"f32_checks": checks, "moe_ep2": moe, "timed_bf16": timed,
            "tp2_job": job}



# The data axis (parallel/zero1.py, quantized.py, sharded_embedding.py,
# cross-rank BatchNorm): the flagship at full width and PROC_LAYERS layers
# for the float32 checks, at full depth (bfloat16) for the timed runs.
DA_CHECK_STEPS = 2
DA_STEPS = 2
DA_RTOL = 1e-4
DA_STATS_RTOL = 1e-5
DA_WIRE_RATIO = 0.27
DA_CTR_BATCH = 16384
DA_CTR_SHARDS = 2
DA_CTR_WARMUP = 2
DA_CTR_STEPS = 5
DA_CTR_LOSS_RTOL = 1e-5
DA_CTR_GRAD_RTOL = 1e-4
DA_BN_BATCH = 128
DA_BN_STEPS = 2
DA_JOB_RECORDS = 32
DA_JOB_TASK = 16
DA_JOB_WORKERS = 2


def _da_trainer(shards, cfg, **kw):
    """An AllReduceTrainer of one process with `shards` data shards sharing
    the card (ELASTICDL_LOCAL_DEVICES)."""
    with _environ(ELASTICDL_LOCAL_DEVICES=str(shards)):
        return _ArControl().trainer(0, lambda: (
            tlm.custom_model(cfg), tlm.loss, tlm.optimizer()), **kw)


def _da_steps(trainer, batches):
    """Trains on `batches`; the losses and each step's ms (host clock, the
    loss read back)."""
    losses, ms = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, _, loss = trainer.train_minibatch(x, y)
        losses.append(loss.item())
        ms.append(1e3 * (time.perf_counter() - start))
    return losses, ms


def _da_shard_launches(trainer, layers, steps):
    """Each shard's launches against one each of the training three per
    layer and step."""
    got = [{k: v for k, v in c.items() if v} for c in trainer.shard_launches]
    want = [{n: layers * steps for n in ("flash_fwd_lse", "flash_dq",
                                         "flash_dkv")}
            for _ in trainer.shard_launches]
    return got, want


def _da_batches(tokens, n):
    return [(tokens[i * BATCH:(i + 1) * BATCH, :-1],
             tokens[i * BATCH:(i + 1) * BATCH, 1:]) for i in range(n)]


def _da_zero1_f32(tokens):
    """The flagship (float32, PROC_LAYERS layers) in one process of two data
    shards, DA_CHECK_STEPS Adam steps with and without zero1: the
    parameters and the gathered optimizer leaves bitwise equal; each
    shard's optimizer state against the replicated state's bytes."""
    cfg = dataclasses.replace(proc_config(), activation_dtype="float32")
    batches = _da_batches(tokens, DA_CHECK_STEPS)
    out = {}
    kept = {}
    for name, kw in (("replicated", {}), ("zero1", {"zero1": True})):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _da_trainer(2, cfg, **kw)
        try:
            losses, ms = _da_steps(trainer, batches)
            got, want = _da_shard_launches(trainer, cfg.n_layers,
                                           DA_CHECK_STEPS)
            out[name] = {"spec": trainer.world_fingerprint,
                         "losses": losses, "ms_per_step": ms,
                         "optimizer_state_bytes":
                             trainer.optimizer_state_bytes(),
                         "shard_launches": got}
            if got != want:
                raise AssertionError(f"data_axis zero1_f32 {name}: "
                                     f"launches {got}, expected {want}")
            params = [p.detach().clone() for p in trainer._model.parameters()]
            leaves = [t.detach().clone() for t in
                      trainer.optimizer_state_leaves()]
            if not kept:
                kept = {"params": params, "leaves": leaves}
                continue
            out["params_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(params, kept["params"]))
            out["optimizer_leaves_bitwise"] = len(leaves) == len(
                kept["leaves"]) and all(torch.equal(a.cpu(), b.cpu())
                                        for a, b in zip(leaves,
                                                        kept["leaves"]))
            opt = trainer._optimizer
            out["sharded_leaves"] = sum(len(parts) for parts in opt.parts)
            out["halves"] = all(
                p.shape[0] * 2 == leaf.to_flax(leaf.param).shape[0]
                for parts in opt.parts for leaf, _, p in parts)
        finally:
            trainer.close()
    if not (out["params_bitwise"] and out["optimizer_leaves_bitwise"]
            and out["halves"] and out["sharded_leaves"]):
        raise AssertionError(f"data_axis zero1_f32: {out}")
    return out


def _da_zero1_timed(tokens):
    """The bfloat16 flagship (full depth) in one process of two data
    shards, with and without zero1: DA_STEPS steps each."""
    cfg = tlm.flagship_config(SEQ)
    batches = _da_batches(tokens, DA_STEPS)
    out = {}
    for name, kw in (("replicated", {}), ("zero1", {"zero1": True})):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _da_trainer(2, cfg, **kw)
        try:
            trainer.init_variables_if_needed(batches[0][0])
            for counts in trainer.shard_launches:
                counts.clear()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = _da_steps(trainer, batches)
            got, want = _da_shard_launches(trainer, cfg.n_layers, DA_STEPS)
            out[name] = {"spec": trainer.world_fingerprint,
                         "losses": losses, "ms_per_step": ms,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30,
                         "optimizer_state_bytes":
                             trainer.optimizer_state_bytes(),
                         "shard_launches": got}
        finally:
            trainer.close()
        if got != want:
            raise AssertionError(f"data_axis zero1_timed {name}: launches "
                                 f"{got}, expected {want}")
    return out


def _da_world(cfg, **kw):
    """Two trainers as threads on the card, a gloo world of 2."""
    control = _ArControl()
    ranks = [control.trainer(i, lambda: (
        tlm.custom_model(cfg), tlm.loss, tlm.optimizer()), multi_host=True,
        **kw) for i in range(AR_WORKERS)]
    for t in ranks:
        t._mc.report_liveness()
    return ranks


def _da_quantized_world(tokens, cfg, steps, check):
    """A quantized world of two ranks as threads, each on half of each
    batch: ms per step, the world's gloo legs and wire per step against the
    f32 all-reduce's wire (the ring model on 4 bytes per parameter and the
    loss), the ranks bitwise equal; with `check`, the first step's reduced
    gradients against the exact mean of the two ranks' own (captured as
    they enter the reduction), within two steps of each block's largest
    member scale."""
    captured = {}
    plain = art.quantized_pmean

    def capture(leaves, group, collectives="all_to_all"):
        if check and len(captured) < group.size:
            captured[group.rank] = torch.cat(
                [t.reshape(-1).float() for t in leaves])
        result = plain(leaves, group, collectives)
        if check and group.rank == 0 and "out" not in captured:
            captured["out"] = torch.cat([t.reshape(-1).float()
                                         for t in result])
        return result

    ranks = _da_world(cfg, quantized_grads=True)
    half = BATCH // AR_WORKERS
    out = {"losses": [], "step_ms": [], "comm": []}
    art.quantized_pmean = capture
    try:
        start = time.perf_counter()
        _in_threads(*[(lambda t=t: t.init_variables_if_needed(
            tokens[:half, :-1])) for t in ranks])
        out["form_world_ms"] = 1e3 * (time.perf_counter() - start)
        fa.reset_launch_counts()
        for i in range(steps):
            rows = tokens[i * BATCH:(i + 1) * BATCH]
            for t in ranks:
                t.world.stats.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses = _in_threads(*[
                (lambda t=t, r=r: t.train_minibatch(
                    rows[r * half:(r + 1) * half, :-1],
                    rows[r * half:(r + 1) * half, 1:])[2])
                for r, t in enumerate(ranks)])
            out["losses"].append([v.item() for v in losses])
            out["step_ms"].append(1e3 * (time.perf_counter() - start))
            out["comm"].append(ranks[0].world.stats.as_dict())
            if not torch.equal(losses[0], losses[1]):
                raise AssertionError(f"data_axis quantized step {i}: the "
                                     "ranks' losses differ")
        out["launches"] = dict(fa.launches)
        out["ranks_bitwise"] = _same_bits(ranks[0], ranks[1])
        out["spec"] = ranks[0].world_fingerprint
        n_params = sum(p.numel() for p in ranks[0]._model.parameters())
    finally:
        art.quantized_pmean = plain
        for t in ranks:
            t.close()
    f32_wire = distributed.wire_bytes("all_reduce", 4 * (n_params + 1), 2)
    wire = float(np.mean([c["wire"] for c in out["comm"]]))
    out.update(params=n_params, f32_wire_bytes=f32_wire,
               wire_bytes_per_step=wire, wire_ratio=wire / f32_wire,
               gloo_ms_per_step=1e3 * float(np.mean(
                   [c["gloo_s"] for c in out["comm"]])))
    want = {n: AR_WORKERS * cfg.n_layers * steps
            for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
    failed = []
    if {k: v for k, v in out["launches"].items() if v} != want:
        failed.append(f"launches, expected {want}")
    if not out["ranks_bitwise"]:
        failed.append("the ranks bitwise")
    if out["wire_ratio"] > DA_WIRE_RATIO:
        failed.append("the wire ratio")
    if check:
        exact = (captured[0] + captured[1]) / 2
        got = captured["out"]
        n = AR_WORKERS
        pad = -exact.numel() % n
        blocks = lambda v: torch.cat([v, v.new_zeros(pad)]).reshape(n, -1)
        scale = torch.maximum(blocks(captured[0]).abs().amax(1),
                              blocks(captured[1]).abs().amax(1)) / 127.0
        err = (blocks(got) - blocks(exact)).abs().amax(1)
        out["block_error_in_steps"] = [float(e) for e in err / scale]
        out["quantized"] = not torch.equal(got, exact)
        if not all(float(e) <= 2 * float(s) for e, s in zip(err, scale)):
            failed.append("the gradients within two steps of the scale")
        if not out["quantized"]:
            failed.append("the mean quantized")
    if failed:
        emit({"phase": "data_axis", "run": "quantized", **out})
        raise AssertionError(f"data_axis quantized world: {failed}")
    return out


def _da_deepfm():
    """DeepFM at its full id space (TOTAL_IDS, padded) with both tables
    row-sharded over DA_CTR_SHARDS members (threads of one gloo group on
    the card), batch DA_CTR_BATCH split over them: one forward and
    backward against the replicated model from the same weights (loss
    DA_CTR_LOSS_RTOL relative, every gradient DA_CTR_GRAD_RTOL of its
    largest), then DA_CTR_WARMUP + DA_CTR_STEPS Adam steps (the dense
    gradients all-reduced over the group): ms per step, gloo bytes."""
    n = DA_CTR_SHARDS
    vocab = padded_vocab(TOTAL_IDS, n)
    batches = _ps_batches(1 + DA_CTR_WARMUP + DA_CTR_STEPS, DA_CTR_BATCH, 7)
    with torch.device("meta"):
        rep = deepfm.DeepFMCriteo(vocab=vocab)
    rep.to_empty(device="cuda")
    rep.init_weights(torch.Generator(device="cuda").manual_seed(0))
    features, labels = batches[0]
    loss = deepfm.loss(labels, rep({k: torch.as_tensor(v).cuda()
                                    for k, v in features.items()}))
    loss.backward()
    want = {x.name: x.to_flax(x.param.grad) for x in flax_leaves(rep)}
    tables = {x.name: x.param.detach() for x in flax_leaves(rep)}
    want_loss = loss.item()
    del loss

    def member(group):
        model = deepfm.custom_sharded_model(group, vocab=vocab)
        model.to_empty(device="cuda")
        with torch.no_grad():
            for x in flax_leaves(model):
                full = tables[x.name]
                if x.name.rsplit("/", 1)[-1] in ("wide", "deep"):
                    full = shard_table_rows(full, group.size)[group.rank]
                x.param.copy_(full)
        b = DA_CTR_BATCH // group.size
        rows = slice(group.rank * b, (group.rank + 1) * b)

        def step(f, l):
            feats = {k: torch.as_tensor(v[rows]).cuda()
                     for k, v in f.items()}
            model.zero_grad(set_to_none=True)
            loss = deepfm.loss(l[rows], model(feats)) / group.size
            loss.backward()
            return loss.detach()

        loss = step(features, labels)
        grads = {x.name: x.to_flax(x.param.grad).clone()
                 for x in flax_leaves(model)}
        opt = deepfm.optimizer().to_torch(model.parameters())
        dense = [p for name, p in model.named_parameters()
                 if name.rsplit(".", 1)[-1] not in ("wide", "deep")]
        group.stats.reset()
        ms = []
        for i, (f, l) in enumerate(batches[1:]):
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(f, l)
            flat = torch.cat([p.grad.reshape(-1) for p in dense])
            flat = group.all_reduce(flat)
            offset = 0
            for p in dense:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
            opt.step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - start))
            if i + 1 == DA_CTR_WARMUP:
                group.stats.reset()
        return loss, grads, ms[DA_CTR_WARMUP:], group.stats.as_dict()

    out = run_group(n, member, axis="data")
    got_loss = float(sum(o[0].item() for o in out))
    errors = {}
    for name, ref in want.items():
        parts = [o[1][name] for o in out]
        got = (torch.cat(parts)[:ref.shape[0]]
               if name.rsplit("/", 1)[-1] in ("wide", "deep")
               else sum(parts))
        errors[name] = float((got - ref).abs().max()
                             / ref.abs().max().clamp_min(1e-30))
    stats = out[0][3]
    result = {"ids": TOTAL_IDS, "padded": vocab, "shards": n,
              "rows_per_shard": vocab // n, "batch": DA_CTR_BATCH,
              "loss": got_loss, "replicated_loss": want_loss,
              "loss_rel_err": abs(got_loss - want_loss) / abs(want_loss),
              "grad_max_rel_err": max(errors.values()),
              "grad_worst": max(errors, key=errors.get),
              "ms_per_step": out[0][2],
              "gloo_per_step": {k: v / DA_CTR_STEPS for k, v in
                                stats.items()}}
    if (result["loss_rel_err"] > DA_CTR_LOSS_RTOL
            or result["grad_max_rel_err"] > DA_CTR_GRAD_RTOL):
        emit({"phase": "data_axis", "run": "deepfm_sharded", **result})
        raise AssertionError("data_axis deepfm_sharded: beyond tolerance")
    return result


def _da_resnet_bn():
    """ResNet-50 (float32) at batch DA_BN_BATCH over two data shards of one
    process, held against LocalTrainer on the whole batch from the same
    weights for one training step: the loss, and the running statistics
    within DA_STATS_RTOL of their largest value; the gradients no farther
    from a float64 copy's (on the card) than ZOO_CHECK_EXACT_RATIO times
    LocalTrainer's own (the zoo's card-against-CPU rule: some 50
    training-mode BatchNorms amplify rounding). Then DA_BN_STEPS steps: ms per step and the
    statistics all-reduces per shard and step."""
    images, labels = _zoo_images(DA_BN_BATCH, 60)

    def make():
        with torch.device("meta"):
            return (resnet50.ResNet50(dtype="float32"), resnet50.loss,
                    resnet50.optimizer())

    local = LocalTrainer(*make(), device="cuda")
    local.init_variables_if_needed(images)
    named, state = params_to_flax(local._model), state_to_flax(local._model)
    with torch.device("meta"):
        exact = resnet50.ResNet50(dtype="float64")
    exact.to_empty(device="cuda")
    exact.double()
    load_flax(exact, named, state)
    _, exact_grads = _zoo_step(exact, images, labels, True)
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    _, _, local_loss = local.train_minibatch(images, labels)
    local_grads = {x.name: x.to_flax(x.param.grad).double().cpu().numpy()
                   for x in flax_leaves(local._model)}
    local_stats = state_to_flax(local._model)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    with _environ(ELASTICDL_LOCAL_DEVICES="2"):
        trainer = _ArControl().trainer(0, make)
    try:
        trainer.load_flax_params(named, state)
        _, _, loss = trainer.train_minibatch(images, labels)
        grads = {x.name: x.to_flax(x.param.grad).double().cpu().numpy()
                 for x in flax_leaves(trainer._model)}
        stats = state_to_flax(trainer._model)
        for counts in trainer.axis_stats.values():
            counts.reset()
        losses, ms = _da_steps(trainer, [(images, labels)] * DA_BN_STEPS)
        calls = trainer.axis_stats["data"].calls
        layers = sum(isinstance(m, BatchNorm)
                     for m in trainer._model.modules())
        spec = trainer.world_fingerprint
        gloo = trainer.axis_stats["data"].as_dict()
    finally:
        trainer.close()
    shard_exact = _grad_err(grads, exact_grads)
    local_exact = _grad_err(local_grads, exact_grads)
    bound = max(DA_RTOL, ZOO_CHECK_EXACT_RATIO * local_exact[0])
    stats_err = max(_rel_err(stats[k], local_stats[k]) for k in stats)
    result = {"spec": spec, "batch": DA_BN_BATCH,
              "loss": loss.item(), "local_loss": local_loss.item(),
              "grads": {"shards_vs_local": _grad_err(grads, local_grads),
                        "shards_vs_float64": shard_exact,
                        "local_vs_float64": local_exact, "bound": bound},
              "running_stats_max_rel_err": stats_err,
              "losses": losses, "ms_per_step": ms,
              "batchnorms": layers,
              "stats_allreduces_per_shard_step": calls / (2 * DA_BN_STEPS),
              "gloo": gloo}
    failed = []
    if abs(result["loss"] - result["local_loss"]) > DA_STATS_RTOL * abs(
            result["local_loss"]):
        failed.append("loss")
    if shard_exact[0] > bound:
        failed.append("gradients against float64")
    if stats_err > DA_STATS_RTOL:
        failed.append("running statistics")
    if calls != 2 * layers * 2 * DA_BN_STEPS:
        failed.append("statistics all-reduces: 2 per BatchNorm and shard")
    if failed:
        emit({"phase": "data_axis", "run": "resnet50_bn", **result})
        raise AssertionError(f"data_axis resnet50_bn: {failed}")
    return result


def _da_job(root):
    """--multi_host --zero1 --quantized_grads through master.main with two
    worker processes of two data shards each, all on the card: a world of
    data 2 x zero 2, the bfloat16 flagship at PROC_LAYERS."""
    return _allreduce_job(root, "data-axis",
                          ["--zero1", "--quantized_grads"], DA_JOB_RECORDS,
                          DA_JOB_TASK, DA_JOB_WORKERS)


def _start_splits(exits):
    """{process: its start split} from the exit lines (seconds from exec
    to the imports, the CUDA context, the master's first answer and the
    model built)."""
    return {role: {k: v for k, v in e["start"].items() if k != "exec"}
            for role, records in exits.items() for e in records
            if "start" in e}


def phase_data_axis(results):
    """The data axis on the card: ZeRO-1 bitwise (float32) and timed
    (bfloat16); the quantized world of two ranks (float32 check, bfloat16
    timed); DeepFM with its tables row-sharded; ResNet-50's BatchNorm over
    two shards; then a two-process --zero1 --quantized_grads job."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    tokens = synthetic_lm_tokens(DA_STEPS * BATCH, SEQ, vocab=32768,
                                 branching=4, seed=0)
    out = {}
    runs = (("zero1_f32", lambda: _da_zero1_f32(tokens)),
            ("zero1_bf16", lambda: _da_zero1_timed(tokens)),
            ("quantized_f32", lambda: _da_quantized_world(
                tokens, dataclasses.replace(proc_config(),
                                            activation_dtype="float32"),
                DA_CHECK_STEPS, check=True)),
            ("quantized_bf16", lambda: _da_quantized_world(
                tokens, tlm.flagship_config(SEQ), DA_STEPS, check=False)),
            ("deepfm_sharded", _da_deepfm),
            ("resnet50_bn", _da_resnet_bn))
    for name, fn in runs:
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        out[name] = fn()
        emit({"phase": "data_axis", "run": name, **card,
              "seconds": time.perf_counter() - start, **out[name]})
    with tempfile.TemporaryDirectory() as root:
        job = _da_job(root)
    job["start_splits"] = _start_splits(job["worker_exits"])
    emit({"phase": "data_axis", "run": "zero1_quantized_job", **card,
          **job})
    exits = job["worker_exits"]
    last = [v[-1] for v in exits.values()]
    per_step = {n: 2 * PROC_LAYERS
                for n in ("flash_fwd_lse", "flash_dq", "flash_dkv")}
    checks_ok = [
        (job["master_rc"] == 0, "the master's exit code"),
        (job["records_done"] == DA_JOB_RECORDS, "records_done"),
        (not job["left"], "no process left"),
        (job["losses"] and all(math.isfinite(v) for v in job["losses"]),
         "finite losses"),
        (sorted(exits) == [f"worker-{i}" for i in range(DA_JOB_WORKERS)],
         "one exit line per worker"),
        (_launch_check(exits, lambda e: {
            n: c * (e["steps"] + e["failed_steps"])
            for n, c in per_step.items()}),
         "each process's launches: 2 shards x layers per step"),
        (all(e["spec"] == "data=2,zero=2|pg|p2" for e in last),
         "data 2 x zero 2 worlds"),
        (len({(e["version"], e["digest"]) for e in last}) == 1
         and last[0]["digest"], "equal version and digest"),
    ]
    failed = [what for ok, what in checks_ok if not ok]
    if failed:
        raise AssertionError(f"data_axis zero1_quantized_job: {failed}")
    out["zero1_quantized_job"] = job
    return out


# The stage axis (parallel/pipeline.py): a process's two stage shards as
# threads sharing the card, the hops on gloo through pinned host buffers.
# float32 checks at the flagship's widths and PROC_LAYERS layers, one step
# of each schedule against LocalTrainer on the same weights (the plain
# tree moved into the staged one through common/params.py); the bfloat16
# flagship at full depth timed, PP_STEPS steps of each schedule at PP_MICRO
# microbatches; the named remat policies on LocalTrainer; a two-process
# 1F1B job.
PP_STAGES = 2
PP_RTOL = 1e-4
PP_LOSS_RTOL = 1e-5
# (schedule, microbatches, virtual stages) of the float32 checks.
PP_CHECKS = (("gpipe", 2, 1), ("1f1b", 2, 1), ("interleaved", 4, 2))
PP_MICRO = 4
PP_VSTAGES = 2
PP_STEPS = 3
PP_REMAT_RTOL = 1e-6
PP_JOB_RECORDS = 32
PP_JOB_TASK = 16
PP_JOB_WORKERS = 2
PP_JOB_MICRO = 2


def _pp_trainer(schedule, micro, vstages, cfg):
    """An AllReduceTrainer of one process with PP_STAGES stage shards
    sharing the card, pipelined by the LM's pipeline_spec hook bound to
    cfg."""
    with _environ(ELASTICDL_LOCAL_DEVICES=str(PP_STAGES)):
        return _ArControl().trainer(
            0, lambda: (tlm.custom_model(cfg), tlm.loss, tlm.optimizer()),
            pipeline_stages=PP_STAGES, pipeline_schedule=schedule,
            pipeline_microbatches=micro, pipeline_virtual_stages=vstages,
            pipeline_spec_fn=functools.partial(tlm.pipeline_spec,
                                               config=cfg))


def _pp_launch_check(trainer, schedule, layers, micro, steps):
    """Each stage shard's launches against the schedule's count: per step
    its layers (summed over its chunks) times the microbatches of
    flash_fwd_lse, flash_dq and flash_dkv, and as many flash_fwd where
    the forward slots run without autograd (1F1B, interleaved)."""
    names = ["flash_fwd_lse", "flash_dq", "flash_dkv"]
    if schedule != "gpipe":
        names.append("flash_fwd")
    per = layers // PP_STAGES * micro * steps
    want = [{n: per for n in names} for _ in range(PP_STAGES)]
    got = [{k: v for k, v in c.items() if v}
           for c in trainer.shard_launches]
    return got, want


def _host_grads(model):
    return {x.name: x.to_flax(x.param.grad).detach().float().cpu().numpy()
            for x in flax_leaves(model)}


def _pp_f32_checks(x, y):
    cfg = dataclasses.replace(tlm.flagship_config(SEQ),
                              n_layers=PROC_LAYERS,
                              activation_dtype="float32")
    local = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                         device=AR_DEVICE)
    local.init_variables_if_needed(x)
    named = params_to_flax(local._model)
    _, _, ref_loss = local.train_minibatch(x, y)
    ref_loss = ref_loss.item()
    ref_grads = _host_grads(local._model)
    del local
    out = {}
    for schedule, micro, vstages in PP_CHECKS:
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _pp_trainer(schedule, micro, vstages, cfg)
        try:
            trainer.load_flax_params(monolithic_to_staged(
                named, PP_STAGES * vstages))
            _, _, loss = trainer.train_minibatch(x, y)
            torch.cuda.synchronize()
            grads = staged_to_monolithic(_host_grads(trainer._model))
            errors = {n: float(np.abs(grads[n] - g).max()
                               / max(float(np.abs(g).max()), 1e-30))
                      for n, g in ref_grads.items()}
            loss_err = abs(loss.item() - ref_loss) / abs(ref_loss)
            got, want = _pp_launch_check(trainer, schedule, cfg.n_layers,
                                         micro, 1)
            out[schedule] = {
                "spec": trainer.world_fingerprint, "microbatches": micro,
                "loss": loss.item(), "local_loss": ref_loss,
                "loss_rel_err": loss_err,
                "max_rel_err": max(errors.values()),
                "worst": max(errors, key=errors.get),
                "shard_launches": got}
        finally:
            trainer.close()
        bad = {k: v for k, v in errors.items() if not v <= PP_RTOL}
        if bad or not loss_err <= PP_LOSS_RTOL or got != want:
            raise AssertionError(
                f"pipeline {schedule}: gradients over {PP_RTOL} {bad}, "
                f"loss error {loss_err}; launches {got}, expected {want}")
    return out


def _pp_timed(tokens):
    """The bfloat16 flagship: LocalTrainer, then each schedule at PP_MICRO
    microbatches, PP_STEPS steps each on the same batches: ms per step,
    the stage axis' gloo legs and bytes per step, peak memory, the losses
    beside LocalTrainer's (reported, not bounded), exact launches."""
    cfg = tlm.flagship_config(SEQ)
    batches = [(tokens[i * BATCH:(i + 1) * BATCH, :-1],
                tokens[i * BATCH:(i + 1) * BATCH, 1:])
               for i in range(PP_STEPS)]
    local = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                         device=AR_DEVICE)
    out = {"local": _timed_steps(local, batches)}
    del local
    for schedule in ("gpipe", "1f1b", "interleaved"):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = _pp_trainer(schedule, PP_MICRO, PP_VSTAGES, cfg)
        try:
            out[schedule] = _timed_steps(trainer, batches)
            got, want = _pp_launch_check(trainer, schedule, cfg.n_layers,
                                         PP_MICRO, PP_STEPS)
            stage = trainer.axis_stats["stage"].as_dict()
            out[schedule].update(
                spec=trainer.world_fingerprint, shard_launches=got,
                stage_gloo_per_step={k: v / PP_STEPS
                                     for k, v in stage.items()})
        finally:
            trainer.close()
        if got != want:
            raise AssertionError(f"pipeline timed {schedule}: launches "
                                 f"{got}, expected {want}")
    return out


def _pp_remat(x, y):
    """The bfloat16 flagship on LocalTrainer, one forward and backward per
    remat policy on the same weights and batch: every gradient against
    remat off (bitwise, else within PP_REMAT_RTOL of its largest value),
    compared on the card; the peak memory of each (less the reference
    gradients kept on the card for the comparison) and its launches."""
    cfg = tlm.flagship_config(SEQ)
    local = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                         device=AR_DEVICE)
    local.init_variables_if_needed(x)
    model = local._model
    model.train()
    xt, yt = local._to_device(x), local._to_device(y)
    # A warm-up step: the first timed step would carry cuBLAS's start.
    tlm.loss(yt, model(xt)).backward()
    out, ref, ref_bytes = {}, None, 0
    for policy in ("off",) + tlm.REMAT_POLICIES:
        model.config = dataclasses.replace(
            cfg, remat=policy != "off",
            remat_policy=None if policy == "off" else policy)
        model.zero_grad(set_to_none=True)
        # The allocator keeps its cache across the policies: emptied, each
        # step would pay for its own cudaMalloc calls in its time.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = collections.Counter()
        start = time.perf_counter()
        with fa.counting_into(launches):
            tlm.loss(yt, model(xt)).backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start)
        peak = (torch.cuda.max_memory_allocated() - ref_bytes) / 2**30
        grads = {n: p.grad for n, p in model.named_parameters()}
        if ref is None:
            ref = {n: g.detach().clone() for n, g in grads.items()}
            ref_bytes = sum(t.numel() * t.element_size()
                            for t in ref.values())
        errors = [float((g - ref[n]).abs().max()
                        / ref[n].abs().max().clamp_min(1e-30))
                  for n, g in grads.items()]
        out[str(policy)] = {
            "ms": ms, "peak_gib": peak,
            "bitwise": all(torch.equal(g, ref[n])
                           for n, g in grads.items()),
            "max_rel_err": max(errors),
            "launches": {k: v for k, v in launches.items() if v}}
        del grads
    bad = {k: v["max_rel_err"] for k, v in out.items()
           if not v["max_rel_err"] <= PP_REMAT_RTOL}
    if bad:
        raise AssertionError(f"pipeline remat: gradients over "
                             f"{PP_REMAT_RTOL} of remat off: {bad}")
    return out


def _pp_job(root):
    """--multi_host --pipeline_stages 2 --pipeline_schedule 1f1b through
    master.main with two worker processes of two stage shards each, all on
    the card: a world of data 2 (across processes) x stage 2 (inside)."""
    return _allreduce_job(
        root, "pipeline",
        ["--pipeline_stages", str(PP_STAGES), "--pipeline_schedule", "1f1b",
         "--pipeline_microbatches", str(PP_JOB_MICRO)],
        PP_JOB_RECORDS, PP_JOB_TASK, PP_JOB_WORKERS)


def phase_pipeline(results):
    """The stage axis on the card: the float32 checks of GPipe, 1F1B and
    interleaved 1F1B against LocalTrainer, the bfloat16 flagship timed
    under each schedule, the named remat policies, then a two-process
    1F1B job through master.main."""
    device = results["device"]
    card = {"card": device["nvidia_smi"]}
    tokens = synthetic_lm_tokens(PP_STEPS * BATCH, SEQ, vocab=32768,
                                 branching=4, seed=0)
    x, y = tokens[:BATCH, :-1], tokens[:BATCH, 1:]
    out = {}
    runs = (("f32_checks", lambda: _pp_f32_checks(x, y)),
            ("timed_bf16", lambda: _pp_timed(tokens)),
            ("remat_bf16", lambda: _pp_remat(x, y)))
    for name, fn in runs:
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        out[name] = fn()
        emit({"phase": "pipeline", "run": name, **card,
              "seconds": time.perf_counter() - start, **out[name]})
    with tempfile.TemporaryDirectory() as root:
        job = _pp_job(root)
    emit({"phase": "pipeline", "run": "1f1b_job", **card, **job})
    exits = job["worker_exits"]
    last = [v[-1] for v in exits.values()]
    per_step = {n: PROC_LAYERS * PP_JOB_MICRO for n in fa.KERNEL_NAMES}
    checks_ok = [
        (job["master_rc"] == 0, "the master's exit code"),
        (job["records_done"] == PP_JOB_RECORDS, "records_done"),
        (not job["left"], "no process left"),
        (job["losses"] and all(math.isfinite(v) for v in job["losses"]),
         "finite losses"),
        (sorted(exits) == [f"worker-{i}" for i in range(PP_JOB_WORKERS)],
         "one exit line per worker"),
        (job["pipelined_inits"] == [(str(PP_STAGES), "1f1b")]
         * PP_JOB_WORKERS, "'Initialized pipelined model' in each worker"),
        (_launch_check(exits, lambda e: {
            n: c * (e["steps"] + e["failed_steps"])
            for n, c in per_step.items()}),
         "each process's launches: 2 stages x layers / 2 x microbatches "
         "of each kernel per step"),
        (all(e["spec"] == "data=2,stage=2|pg|p2" for e in last),
         "data 2 x stage 2 worlds"),
        (len({(e["version"], e["digest"]) for e in last}) == 1
         and last[0]["digest"], "equal version and digest"),
    ]
    failed = [what for ok, what in checks_ok if not ok]
    if failed:
        raise AssertionError(f"pipeline 1f1b_job: {failed}")
    out["1f1b_job"] = job
    return out


def main():
    phases = [("device", phase_device), ("build", phase_build),
              ("kernels", lambda: phase_kernels(results["build"])),
              ("reference", phase_reference), ("main_path", phase_main_path),
              ("job", lambda: phase_job(results["main_path"])),
              ("moe_lm", phase_moe_lm),
              ("ps_step", phase_ps_step), ("ps_job", phase_ps_job),
              ("ctr_zoo", phase_ctr_zoo), ("lm_ps", phase_lm_ps),
              ("zoo", phase_zoo),
              ("processes", lambda: phase_processes(results)),
              ("client", lambda: phase_client(results)),
              ("k8s", lambda: phase_k8s(results)),
              ("allreduce", lambda: phase_allreduce(results)),
              ("model_axes", lambda: phase_model_axes(results)),
              ("data_axis", lambda: phase_data_axis(results)),
              ("pipeline", lambda: phase_pipeline(results))]
    results, seconds = {}, {}
    for name, fn in phases:
        # A finished phase's trainers sit in reference cycles until the
        # collector runs; free them, so that each phase's peak memory is
        # its own.
        gc.collect()
        torch.cuda.empty_cache()
        try:
            if name == "ps_step":
                fa.reset_launch_counts()
            start = time.perf_counter()
            results[name] = fn()
            seconds[name] = time.perf_counter() - start
            if name == "ps_step":
                # The PS path runs no flash-attention kernel.
                ps_launches = dict(fa.launches)
                emit({"phase": "ps_step", "launches": ps_launches})
                if any(ps_launches.values()):
                    raise AssertionError(f"ps_step launches {ps_launches}")
        except Exception as e:  # report which phase failed, then stop
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            return 1
    report = results["kernels"]
    for name in fa.KERNEL_NAMES:
        # `launches`: the job, the main path a user runs; beside it the
        # direct LocalTrainer run of the train and eval phases.
        report[name]["launches"] = results["job"].get(name, 0)
        report[name]["train_phase_launches"] = (
            results["main_path"]["launches"].get(name, 0))
        # The flagship on the parameter server, one job per wire.
        report[name]["lm_ps_launches"] = {
            wire: r["launches"].get(name, 0)
            for wire, r in results["lm_ps"].items()}
        # The Switch-MoE LM at the flagship's widths: direct (warm-up and
        # timed steps, one evaluation) and as a job through the master.
        report[name]["moe_lm_launches"] = {
            run: results["moe_lm"][run]["launches"].get(name, 0)
            for run in ("direct", "job")}
        # The image and tabular zoo launches none.
        report[name]["zoo_launches"] = results["zoo"]["launches"].get(
            name, 0)
        # The flagship's worker processes of the processes phase, as each
        # process logged them at its exit.
        report[name]["proc_lm_launches"] = {
            role: e["kernel_launches"].get(name, 0)
            for role, v in results["processes"]["proc_lm"][
                "worker_exits"].items() for e in v}
        # The worker processes of `edl train` and `edl predict`, and the
        # worker pods of the k8s job (the preempted one logged none).
        report[name]["client_launches"] = {
            job: e["kernel_launches"].get(name, 0)
            for job in ("train", "predict")
            for v in results["client"][job]["worker_exits"].values()
            for e in v}
        report[name]["k8s_launches"] = {
            pod: e["kernel_launches"].get(name, 0)
            for pod, v in results["k8s"]["worker_exits"].items()
            for e in v}
        # Elastic AllReduce: the in-process part (one-process world, two
        # ranks as threads and their LocalTrainers), then each rank
        # process of proc_ar as it logged at its exit.
        ar = results["allreduce"]
        report[name]["allreduce_launches"] = {
            "ar_step": ar["launches"].get(name, 0),
            **{role: e["kernel_launches"].get(name, 0)
               for role, v in ar["proc_ar"]["worker_exits"].items()
               for e in v}}
        # The model and seq axes: each shard of the f32 checks (one step),
        # the timed bfloat16 runs (MA_STEPS steps) and the two-process TP2
        # job's processes (all their shards).
        ma = results["model_axes"]
        report[name]["model_axes_launches"] = {
            **{run: [c.get(name, 0) for c in r["shard_launches"]]
               for run, r in {**ma["f32_checks"], "moe_ep2": ma["moe_ep2"],
                              **{f"timed_{k}": v for k, v in
                                 ma["timed_bf16"].items() if k != "local"}
                              }.items()},
            **{role: e["kernel_launches"].get(name, 0)
               for role, v in ma["tp2_job"]["worker_exits"].items()
               for e in v}}
        # The data axis: each shard of the ZeRO-1 runs, the quantized
        # worlds' two ranks together, and each process of its job.
        da = results["data_axis"]
        report[name]["data_axis_launches"] = {
            **{f"{run}_{kind}": [c.get(name, 0) for c in r["shard_launches"]]
               for run in ("zero1_f32", "zero1_bf16")
               for kind, r in da[run].items()
               if isinstance(r, dict) and "shard_launches" in r},
            **{run: da[run]["launches"].get(name, 0)
               for run in ("quantized_f32", "quantized_bf16")},
            **{role: e["kernel_launches"].get(name, 0)
               for role, v in da["zero1_quantized_job"][
                   "worker_exits"].items() for e in v}}
        # The stage axis: each stage shard of the float32 checks (one
        # step) and the timed runs (PP_STEPS steps), the remat policies'
        # one step each, and each process of the 1F1B job.
        pp = results["pipeline"]
        report[name]["pipeline_launches"] = {
            **{f"{run}_{schedule}": [c.get(name, 0)
                                     for c in r["shard_launches"]]
               for run in ("f32_checks", "timed_bf16")
               for schedule, r in pp[run].items()
               if "shard_launches" in r},
            **{f"remat_{policy}": r["launches"].get(name, 0)
               for policy, r in pp["remat_bf16"].items()},
            **{role: e["kernel_launches"].get(name, 0)
               for role, v in pp["1f1b_job"]["worker_exits"].items()
               for e in v}}
    emit({"phase_seconds": seconds})
    emit({"kernels": [report[n] for n in fa.KERNEL_NAMES]})
    device = results["device"]
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
