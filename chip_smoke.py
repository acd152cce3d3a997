#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stable_diffusion_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line; any failure exits nonzero:

1. env: the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, and the time to build the CUDA kernels from ``csrc/``. Then
   (``stage``) seeded random pretrained weights written under
   ``build/chip_smoke_pretrained`` in the layouts a user stages for
   ``--model-dir`` (``stage_pretrained``): the SD-1.5 UNet as a
   reference-format ``unet.pt``, the SD-1.5 diffusers VAE as ``vae/`` with
   ``config.json`` and ``diffusion_pytorch_model.bin``, the HF text encoder
   as ``text_encoder/model.safetensors``, a torchvision
   ``inception/inception_v3.pth`` and an HF CLIP ViT-L/14 as
   ``clip_full/model.safetensors`` (the port's safetensors writer).
2. kernels: every ported kernel against its plain PyTorch version on the card,
   at every distinct shape the main paths launch, recorded from a one-step run
   of each (the 512x512 txt2img slice; 1024x1024 txt2img; the hires fix's
   refine; the server's buckets of 2 and 4 requests at 512x512, UNet batch 4
   and 8 with CFG; one micro step of SD-1.5 training at 512x512, batch 4, at
   1024x1024, batch 1, of the lean configuration at 512x512, batch 16, of
   the SD-1.5 VAE's training at 256x256, batch 4, of phase 9c's three
   trainers and of phase 9d's new shapes (the latent cache's VAE encoder at
   a batch of 16 at 512x512; run (a)'s micro step, every kernel at half its
   batch of 4; the UNet and VAE trainers at 256x256 from uint8 rows) and of
   phase 9e's (the staged diffusers VAE's bf16 decode at 512x512: K6 at
   GroupNorm eps 1e-6, which K6's launch key and its record carry; a
   CLIP-score batch of 16 through the ViT-L/14 tower in f32: K1 at
   [16, 257, 257, 16, 64]), each
   trainer built for its probe and freed after it, taken with
   an optimizer that applies nothing; and ``EXTRA_BWD_SHAPES``: the 512px VAE bottleneck's backward,
   [1,4096,4096,1,512], and the f32 VAE parity's on K3): flash
   attention forward (K1, also at the kv > 9216 shapes of the TPU's K2),
   its fused backward (K3) and its split backward (K4/K5, at its own shapes
   and at every K3 shape, K4's domain), CUDA C++, both backward routes
   launched twice (their sums run in a fixed order: the two results must
   agree bit for bit), the VAE's single head of 512 included;
   GroupNorm (K6), GroupNorm-concat (K8) and their backward (K7, which also
   serves the concat form's backward), CUDA C++ on thread-block clusters,
   each of which must queue exactly one device kernel per call (the
   device's records under torch.profiler, ``device_kernels``) and, K7 and
   K8, give the same bits from two launches;
   their bfloat16 records also hold ``graph_ms``, the device time of a call
   read from a replayed CUDA graph of 10 calls (the eager ``ms`` of a small
   call is the wrapper's host time);
   the int8 Adam update (K9), CUDA C++, through its one-leaf entry at each of
   the 49 parameter shapes of the SD-1.5 UNet in the port's layout (conv
   weights channels_last), from seeded non-zero state with step-3 bias
   corrections (and at the DreamBooth LoRA's 7 factor-leaf shapes),
   gradient in float32 and bfloat16: the update at rtol 1e-6,
   codes at most one apart at no more than one in 10^4, dequantized moments
   at rtol 1e-5 / atol 1e-8 elsewhere; and (``adam8bit_step``) the whole
   optimizer step as the trainer launches it, one launch over the 686 leaves
   with the clip and the parameter apply fused in, f32 and bf16 gradients,
   the clip active and not (``adam8bit_step_lora``: the same over the LoRA's
   256 factor leaves), against ``adam8bit_step_plain`` on the card:
   parameters, codes and scales bit-identical, one device kernel a step
   and it K9's (the device's records; the same check must fail, and fails,
   for a wrapper whose launch is elided: ``elided_launch_control``, the
   launch captured into a CUDA graph never replayed); no PyTorch call
   computes it (``library_ms`` null); its
   bound counts bytes and the f32 peak. Then, as context, the whole optimizer
   step over the 686 leaves: the f32 foreach ``AdamW._update`` and
   ``AdamW8bit._update``, the fused step against the per-leaf loop it
   replaced (the clip, the one-leaf K9 launch and the apply, leaf by leaf).
   In float32 (TF32 off) and bfloat16: the implementation each attention
   record ran (``impl``, as the launch reported it: bfloat16 K1, K3 and K4/K5
   on the tensor cores, ``wgmma``; float32 on FMAs, ``fma``; any other pairing
   fails), max-abs error with its tolerance (of each output's max(1,
   max|plain|); bfloat16 attention of its own max|plain|, ``scale`` in the
   record); the kernel's and the library call's times (CUDA events, median
   of 5 runs of 5 launches) and the plain version's (median of 3 single
   launches after one: context, not a yardstick); and the bound: the larger of bytes / 3.35
   TB/s and FLOPs / peak (989 TFLOP/s bf16, 67 TFLOP/s f32; H100 SXM data
   sheet); for attention also bf16 sums by group (K1 at kv <= 9216 and at
   the K2 shapes, the split backward at K3's shapes and at its own). The
   plain attention versions hold f32 [B, H, N, M] scores; past
   2^30 elements they run one (batch, head) at a time (``plain_per_head`` in
   the record), the same per-row math.
   Then (``correlated``) both bf16 backward routes at correlated views (dO =
   Q, V = K, keys sharing a component of 3) at the 512px self-attention
   shapes of head dims 40, 80 and 160, each output within 2e-2 of its own
   max|plain|; and K3 against the split set at K3's shapes, with the route
   ``backward_route`` takes there.
3. unet_parity: one SD-1.5-size UNet forward (full widths, 64x64 latent,
   32 groups) in float32 on the card with the kernels, against the same
   weights and inputs on the CPU through the plain path (a deliberate CPU
   reference), within 1e-4 of the output's scale, and the bf16 forward's
   drift from it (recorded): ``scripts/full_scale_parity.py:unet_parity``.
4. train_parity: one SD-1.5-size UNet forward and backward (32x32 latent,
   batch 1) in float32, card with the kernels vs CPU through the plain path:
   the relative gradient error overall and of the worst tensor (float32
   keeps the JAX crossover, so this backward runs K3); then the
   training step's precision (bf16 autocast over the same f32 weights) vs
   f32 on the card: output drift and gradient drift.
4b. vae_train_parity: one SD-1.5 VAE train step (``make_vae_train_step``) in
   float32 at 64x64, batch 1, the posterior noise handed in, card (K1, K3 at
   the bottleneck's heads of 512 and 128, K6, K7) vs CPU through the plain
   path: the loss and its parts within 1e-5 relative, the gradients within
   the limits of phase 4; K3 must have run at head dim 512.
5. slice: ``pipeline.sample`` at 512x512, DDIM with CFG 7.5, bf16, seeded
   random weights; checks the decoded image is [B, 512, 512, 3] and finite and
   that each forward kernel was launched by this run; seconds per step and
   images/s.
6. hires: (a) ``pipeline.sample`` at 1024x1024, DDIM with CFG 7.5, bf16,
   whole decode: the image is [1, 1024, 1024, 3] and finite and K1 ran at kv
   16384; seconds per step, images/s, peak memory. (b) the hires fix: 512x512
   base, ``hires_scale=2``, ``hires_strength=0.6``, ``vae_tile=64``, a
   1024x1024 image from finite tiles; then its stages timed one by one (base
   loop, refine, tiled and whole decode of the refined latent) and the max
   difference between the tiled and the whole decode (no limit: the JAX
   package calls tiled decode an approximation); ``torch.profiler`` over two
   1024x1024 DDIM steps: device ms per step by kernel category.
6b. samplers: ``pipeline.sample`` at 512x512, batch 1, CFG 7.5, 10 steps,
   once per sampler (ddim, ddpm, dpmpp, euler, euler_a, heun, dpmpp_sde),
   the four sigma-space ones also on Karras spacing, dpmpp with
   v-prediction and trailing spacing on the zero-terminal-SNR schedule, and
   dpmpp with guidance rescale 0.7: each decodes to a finite [1,512,512,3],
   launches K1, K6 and K8, and calls the UNet once a step (heun twice, once
   on its last step); seconds per step of each loop alone.
6c. serve: the port's HTTP server (``scripts/serve.py``, ``build_service``
   at SD-1.5 width, 512x512, ``--max-batch 4``, 10 DDIM steps) in process on
   127.0.0.1: /healthz lists the seven samplers; four solo requests, then the
   same four at once (fewer than 4 batches; requests/s, solo p50, the
   co-batched PNGs' gap to the solo ones in uint8 levels); one request per
   sampler; the async route; /reload of a perturbed UNet checkpoint (a new,
   repeatable image; a missing path is a 400 and serving goes on). Any other
   answer fails the phase. Before it, on the model alone, a bucket row
   against its solo render (``_bucket_vs_solo``): the UNet call within 2e-2
   of scale in bf16, the float32 image within 2e-2; the bf16 image's gap
   recorded beside the loop's own sensitivity to x_T moved by a bf16 ulp.
6d. features (run before 6c, on the slice's model): the sampling-side
   features at 512x512, batch 1, CFG 7.5, bf16, 10 DDIM steps, each through
   the pipeline entry point and each decoded to a finite [1,512,512,3] with
   K1, K6 and K8 launched: a plain
   run (the counts' baseline); a weighted prompt of two 77-token chunks
   (context [1,154,768], K1 at kv 154); img2img at strength 0.75; inpaint
   with a half mask (the kept half of the last latent is the encoded init,
   bit for bit); DeepCache at interval 3 (each UNet call's K1 is the full
   call's or, on a cached step, the level-0 blocks', both from the block
   plans, ``feature_plans``); one ControlNet, then two, zero convs filled
   (K1 and K6 a step above the plain run's by the plan's encoder count
   times the nets; another image); txt2img on the same seeded model with a
   rank-8 LoRA merged into its f32 weights before the cast (another image);
   a textual-inversion prompt loaded from a checkpoint in the port's layout.
   Each run's s/step is CUDA-event time from its first model call to the
   VAE decode, over its UNet calls.
7. train: the UNet trainer in process at SD-1.5 width, 512x512, batch 4,
   synthetic data, bf16 compute over f32 parameters, gradient accumulation 4
   (the default), two optimizer steps and one evaluation; checks a finite
   loss, changed parameters and that its five kernels (K1, the split
   backward, K6, K7, K8: bfloat16 attention backward runs the split set at
   every kv length, ``backward_route``) were launched by this run;
   samples/s, step ms p50, peak memory and the optimizer state's bytes. The trainer is built where its
   phase runs, after every other phase's model and trainer is freed, so the
   peak (after ``reset_peak_memory_stats``) is this configuration's own.
   Then ``torch.profiler`` over one more accumulation window: device ms per
   micro step by kernel category and the device's idle share (the
   profiler's own cost included).
8. hires_train: the same at 1024x1024, batch 1, the 16384-token
   self-attention's backward included.
9. lean_train: the same at 512x512, batch 16, with ``--use-8bit-adam
   --accum-dtype bf16 --remat-policy conv-save``: K9 must run once per
   optimizer step (every leaf in one launch), and K1, the split set, K6, K7,
   K8 run.
9b. vae_train: the autoencoder trainer (``scripts/train_autoencoder.py:
   build_trainer``) at the SD-1.5 VAE's width, 256x256, batch 4, accumulation 4,
   bf16 over f32 parameters, AdamW, two optimizer steps and one evaluation
   (at ``(step + 1) % log_interval``): finite losses, changed parameters,
   K1, the split set (the bottleneck's head of 512 in the backward), K6 and
   K7 launched; then its profile as phase 7's.
9c. personalize: the three personalization entry points' trainers
   (``build_personalize_trainer``) at SD-1.5 width, 512x512, UNet batch 4,
   bf16 over f32, accumulation 4, weight decay 0, two optimizer steps and
   one evaluation, each built where it runs and freed: DreamBooth with a
   rank-8 LoRA, prior preservation (4 class images sampled first) and int8
   Adam; textual inversion (2 vectors); ControlNet (the encoder copy, edge
   hints). Each takes phase 7's checks and record (K9 once per optimizer step
   in the DreamBooth run), the launches of one more micro step, the frozen
   UNet, VAE and CLIP bit-identical after it, which tensors moved at each
   step (LoRA's B and the zero convs at step 1, A and the encoder copy only
   at step 2), and its checkpoint loaded by the sampling side's loaders into
   a 10-step DDIM sample that decodes to a finite [1,512,512,3] unlike the
   untrained model's.
9d. train_options: the rest of the trainers' options at SD-1.5 width through
   the entry points' ``build_trainer``, bf16 over f32, UNet batch 4, each run
   built where it runs and freed, each with phase 7's record and checks
   (``phase_train``, which also counts one more micro step alone):
   (a) 512x512, ``--zero-terminal-snr --prediction-type v_prediction
   --snr-gamma 5 --log-grad-noise-scale --spike-threshold 3 --log-image``,
   5 optimizer steps at accumulation 2, the evaluation and a logged 50-step
   sample on the last: ``grad_noise_scale`` recorded at step 5 only; a micro
   step launches K1, the split set, K6, K7 and K8 twice as often as train
   512's, every K1 and split-set launch at the half batch; the logged sample
   decodes to a finite [1,512,512,3]. (b) ``--latent-cache``: the cache of
   16 synthetic rows built on the card (moments [16,64,64,8] f32, the text
   [16,77,768] f16), 2 steps from it: a micro step calls neither the VAE
   encoder nor CLIP, its K1, K6 and K8 equal one UNet call's block plan, its
   profiled launches fall below train 512's. (c) ``--device-preprocess
   --random-flip``, the UNet trainer and the VAE trainer (with
   ``--log-grad-noise-scale``: its K1 and split set at the half batch) at
   256x256 batch 4, 2 steps each; ``device_preprocess`` on the card within
   1e-4 of its CPU run (the card's antialiased resize sums its taps in
   another order: 2.4e-5 at [4,300,400,3] -> 256). (d) ``--no-fused-adamw`` at accumulation 2, 2 steps,
   a fused ``AdamW`` over copies of the starting parameters fed the same
   gradients: the parameters within 1e-3 of the learning rate beyond 2^-22
   of their size after step 2.
   Hugging Face datasets and wandb are absent on the card's machine (and it
   has no network): those paths are held by the CPU tests only.
9e. eval: from the staged directory, (a) the port's txt2img ``main`` with
   ``--model-dir`` at SD-1.5 width, 512x512, batch 1, 10 DDIM steps, CFG 7.5,
   bf16: its log names the UNet, the VAE and the text encoder as loaded;
   every loaded tensor equals the one written (made again from its seed),
   bit for bit, through the cast (GroupNorm affine f32, the rest bf16); the
   run launches K1 at the diffusers decode's [1, 4096, 4096, 1, 512]; the
   decode alone launches that K1 once and K6 once per GroupNorm of the
   diffusers decoder (30); the PNG is a 512x512 RGB image; s/step and the
   decode's ms. (b) FID: 32 seeded 512x512 images through the canonical
   extractor (``utils/fid.py:InceptionFeatureExtractor``, f32 without TF32,
   299x299) on the card and on the CPU, features within ``FID_FEATURE_TOL``
   of their scale; |FID(set, itself)| below 1 % of FID(set, the set shifted
   by 0.5); seconds per 32 images and peak GB. (c) ``CLIPScorer`` over the
   32 images and prompts with the staged ViT-L/14, f32: K1 ran at
   [16, 257, 257, 16, 64] only, 48 times, every launch ``fma``; the card's
   similarities within ``CLIP_SIM_TOL`` of the CPU's; seconds per image.
9f. parallel: multi-device training on the one card, at SD-1.5 width,
   512x512, batch 4, accumulation 1, 8 optimizer steps a run (2 warm-up,
   6 timed), cuDNN's deterministic convolutions, every run from the staged
   weights (``--model-dir``): (a) the UNet entry point (``build_trainer``)
   in one subprocess under ``python -m torch.distributed.run
   --nproc_per_node 1`` (this script with ``--parallel-child``), over NCCL,
   once each with ``--num-devices 1``, ``--shard-optimizer-state
   --use-8bit-adam``, ``--shard-params``, ``--offload-optimizer`` and
   ``--offload-optimizer --use-8bit-adam``, against one process with no
   flag (f32 AdamW, or int8 Adam for the int8 runs; their parameters handed
   over in a file): the backend is ``nccl``; the runs start from the same
   weights; DDP, ZeRO and offload give the same losses and parameters bit
   for bit; FSDP's update (final minus initial parameters) is within
   ``PARALLEL_UPDATE_TOL`` of the baseline's (over all leaves, the median
   leaf, the worst leaf) and its losses within ``PARALLEL_LOSS_TOL``, while
   the same check fails each ``PARALLEL_CONTROLS`` path (no update, half the
   learning rate, the wrong sign); offload leaves no optimizer state on the
   card between steps, and the checkpoint it saves after the steps (and,
   ``PARALLEL_RESTORE``, restores: the state then compared) raises the
   card's memory by at most one leaf's moments; the train kernels ran,
   K9 once per step (per group of leaves under offload); samples/s, step ms
   p50 (and min, max), peak GB, the optimizer state's bytes on the card and
   the host transfers' seconds per step; (b) K9 per ZeRO shard: the 686
   leaves cut by the port's rule for 2, 4 and 8 ranks, one launch per
   simulated rank over its slices and whole leaves, put back together equal
   bit for bit to one launch over the whole leaves (parameters, codes,
   scales); ms and the int8 state's bytes per simulated rank. Two ranks on
   the one card are not run (NCCL puts one rank on a device).
9g. tools (run after 9e, before 9f): the evaluation and interop tools
   (``scripts/``) on the card, each sub-check failing the run: (a) ``stage_check`` over symlinks to the
   staged artifacts, a synthetic ``tokenizer/`` and the SD-1.5
   ``unet_config.json``: all six ``ok``, exit 0, the UNet's 1x16x16x4 probe
   card vs CPU (``cpu-parity``, 1e-3); (b) an empty directory exits 2 with
   all six missing, ``--only unet`` over a ``unet.pt`` of wrong keys exits
   1; (c) ``full_scale_parity``: the reference's default UNet on a 64x64
   latent, the SD-1.5 VAE at ``TOOLS_VAE_SIZE`` and the 5-step compat loop
   on a ``TOOLS_LOOP_LATENT`` latent, card vs CPU within 1e-4 (forwards)
   and 2e-3 (the loop) of scale, the bf16 drift recorded; (d) ``fid_eval``
   at ``FID_RUN`` with the random-Inception ensemble: fid(compat, default)
   above ``FID_ORDER`` times the compat floor, latent and image; (e)
   ``fid_samplers`` cut to ``FS_RUN``: the quick-train's loss falls, DDIM's
   RMSE to the target falls with steps; (f) ``export_torch`` of a
   checkpoint of the staged UNet, reloaded strictly, and
   ``convert_inception`` of the staged ``.pth``, loaded back: both
   bit-equal; (g) ``--config-file zero2.json`` by name: the UNet trainer
   at SD-1.5 width, 256x256, batch 4, one optimizer step; ``perf.json``
   raises naming item 20. Then (``tools_kernels``) every kernel at each
   launch shape of 9g that phase 2 did not hold, in the dtype 9g launched
   it in, against its plain version (no timings).
10. checkpoint: small-width runs on the card, the f32 optimizer and the lean
   one (int8 Adam, bf16 accumulator), each save ``checkpoint-2``; a second
   trainer resumed from ``latest`` holds exactly the saved state.

After each phase, its wall seconds on a line of their own: ``{"phase":
..., "seconds": ...}`` (``total`` the whole run's). Then, each on its own
line: the ``nvidia-smi`` name/power-limit line, the ``{"kernels": [...]}``
summary, and ``{"ok": true, "device": ...}`` last. In the summary,
``launches`` counts phases 5 to 9g, 6b, 6c and 6d included (each
run with the counts set to 0 just before it; the split is in the JSON
record; 9f's comparison of K9 per shard is not counted); ``max_abs_err``,
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are phase 2's bfloat16
numbers summed over the kernel's distinct shapes (one launch of each; for K9
the whole step's one launch over the 686 leaves with a bfloat16 gradient,
the lean path's, and the clip active); ``impl`` is the implementation each
dtype's records ran (null for a kernel with one).
Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result. Weights are random from a seed, with the
zero-initialized layers (each ResBlock's last conv, each transformer's
proj_out) filled too, so every path contributes to the outputs and gradients.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0          # of the random weights
STEPS = 10        # DDIM steps of the slice and hires runs
NUM_IMAGES = 1    # per slice run; CFG doubles the UNet batch
HIRES = 1024      # image side of the hires runs: a 128x128 latent, 16384 tokens
HIRES_BASE = HIRES // 2  # the hires fix's first stage, upscaled x2
HIRES_TILE = 64   # latent tile of the hires fix's tiled decode
TRAIN_BATCH = 4
HIRES_TRAIN_BATCH = 1
LEAN_TRAIN_BATCH = 16
LEAN_FLAGS = ("--use-8bit-adam", "--accum-dtype", "bf16", "--remat-policy", "conv-save")
TRAIN_STEPS = 2   # optimizer steps of each train phase (x4 micro steps)
VAE_TRAIN = 256   # image side of the VAE training run: a 32x32 latent, its bottleneck [4, 1024, 1024, 1, 512]
VAE_TRAIN_BATCH = 4
VAE_PARITY = 64   # image side of the f32 VAE gradient parity: its bottleneck [1, 64, 64, 1, 512] runs K3
# the samplers phase: (run, pipeline.sample arguments), 512x512, batch 1, CFG 7.5,
# STEPS steps; "zt" runs on the zero-terminal-SNR schedule
SAMPLER_RUNS = (
    ("ddim", {"sampler": "ddim"}), ("ddpm", {"sampler": "ddpm"}), ("dpmpp", {"sampler": "dpmpp"}),
    ("euler", {"sampler": "euler"}), ("euler_a", {"sampler": "euler_a"}), ("heun", {"sampler": "heun"}),
    ("dpmpp_sde", {"sampler": "dpmpp_sde"}),
    ("euler_karras", {"sampler": "euler", "karras": True}), ("euler_a_karras", {"sampler": "euler_a", "karras": True}),
    ("heun_karras", {"sampler": "heun", "karras": True}),
    ("dpmpp_sde_karras", {"sampler": "dpmpp_sde", "karras": True}),
    ("dpmpp_v_trailing_zt", {"sampler": "dpmpp", "prediction_type": "v_prediction", "timestep_spacing": "trailing"}),
    ("dpmpp_guidance_rescale", {"sampler": "dpmpp", "guidance_rescale": 0.7}),
)
DEEP_CACHE_INTERVAL = 3  # the features phase's DeepCache: the trunk refreshed on steps 0, 3, 6, 9
LORA_RANK = 8
SERVE_MAX_BATCH = 4
SERVE_BUCKETS = (1, 2, 4)  # the power-of-two batches the server pads a group to
SERVE_SEEDS = (11, 12, 13, 14)
SERVE_WINDOW_MS = 100      # the batcher's window: the burst's four requests land in it
SERVE_PROMPT = "a photograph of an astronaut riding a horse"
# backward shapes no probe run reaches, held in phase 2 all the same ([B, N, M, H, D]):
# the VAE bottleneck of 512px VAE training (batch 1), on bf16's split set; the f32 parity's two heads on K3
EXTRA_BWD_SHAPES = {"flash_attention_bwd_split": {(1, 4096, 4096, 1, 512)},
                    "flash_attention_bwd": {(1, 64, 64, 1, 512), (1, 64, 64, 1, 128)}}
KV_RESIDENT_MAX = 9216  # the JAX backward crossover, kv padded to 128: K3's domain
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TPU_KERNELS = {
    "flash_attention": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention.cu",
                        "stable_diffusion_pytorch_tpu/ops/flash_attention.py:45 _fa_kernel (K1), "
                        ":113 _fa_kernel_stream (K2)"),
    "flash_attention_bwd": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
                            "stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py:102"),
    "flash_attention_bwd_split": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention_bwd_split.cu",
                                  "stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py:51 _dq_kernel, "
                                  ":61 _dkv_kernel (K4); :355 _sbwd_stats_kernel, :406 _sbwd_dq_kernel, "
                                  ":443 _sbwd_dkv_kernel (K5)"),
    "group_norm": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/group_norm.cu",
                   "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:44"),
    "group_norm_bwd": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/group_norm_bwd.cu",
                       "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:71"),
    "group_norm_cat": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/group_norm.cu",
                       "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:187"),
    "adam8bit_update": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/adam8bit_update.cu",
                        "stable_diffusion_pytorch_tpu/ops/adam8bit_update.py:98 _kernel (pallas_call :188)"),
}
# the implementation each dtype must run, for the kernels whose sources hold two
EXPECTED_IMPL = {name: {"float32": "fma", "bfloat16": "wgmma"}
                 for name in ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_split")}
# kernels whose sums run in a fixed order: a second launch on the same inputs must give the same bits
REPEAT_IDENTICAL = ("flash_attention_bwd", "flash_attention_bwd_split", "group_norm_cat", "group_norm_bwd")
# kernels whose wrapper must queue exactly one device kernel per call; their
# bf16 device time is also read from a CUDA graph of calls (``graph_ms``),
# apart from the host time of an eager call
ONE_LAUNCH = ("group_norm", "group_norm_cat", "group_norm_bwd")
SLICE_KERNELS = ("flash_attention", "group_norm", "group_norm_cat")
# bf16 training: the attention backward routes to the split set at every kv
# length (backward_route); f32 keeps the JAX crossover, so the f32 gradient
# parity runs K3
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_split", "group_norm", "group_norm_bwd", "group_norm_cat")
F32_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "group_norm", "group_norm_bwd", "group_norm_cat")
LEAN_TRAIN_KERNELS = (*TRAIN_KERNELS, "adam8bit_update")
# the VAE has no skip concat (no K8); f32 keeps the crossover, so its parity runs K3
VAE_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_split", "group_norm", "group_norm_bwd")
VAE_F32_KERNELS = ("flash_attention", "flash_attention_bwd", "group_norm", "group_norm_bwd")
# phase 9c: the personalization trainers at 512x512, each a UNet batch of 4 a
# micro step (DreamBooth: 2 instance rows and 2 class rows), weight decay 0 so
# that a tensor without gradient stays exactly where it was
PERSONALIZE_RUNS = ("dreambooth_lora", "textual_inversion", "controlnet")
PERSONALIZE_SIZE = 512
PERSONALIZE_BATCH = 4
NUM_CLASS_IMAGES = 4
NUM_INSTANCE_IMAGES = 16  # 8 micro batches of 2 pairs an epoch: both optimizer steps in one epoch
PERSONALIZE_KERNELS = {"dreambooth_lora": (*TRAIN_KERNELS, "adam8bit_update"), "textual_inversion": TRAIN_KERNELS,
                       "controlnet": TRAIN_KERNELS}
# phase 9d: the rest of the trainers' options, SD-1.5 width, each run built
# where it runs and freed. (a) the objective and the logging, 512x512 batch 4:
# grad_noise_scale is first reported at optimizer step 5
OBJECTIVE_STEPS = 5
OBJECTIVE_FLAGS = ("--zero-terminal-snr", "--prediction-type", "v_prediction", "--snr-gamma", "5",
                   "--log-grad-noise-scale", "--spike-threshold", "3", "--log-image",
                   "--max-train-steps", str(OBJECTIVE_STEPS), "--log-interval", str(OBJECTIVE_STEPS),
                   "--gradient-accumulation-steps", "2")
# (b) the latent cache of 16 synthetic rows at 512x512 (one encoder batch of 16)
CACHE_ROWS = 16
# (c) on-device preprocessing with flips, the UNet and the VAE trainer at 256x256 batch 4
PREPROCESS_SIZE = 256
PREPROCESS_FLAGS = ("--device-preprocess", "--random-flip")
# card vs CPU: the bar tests/test_torch_port_data_options.py states for another
# device's resize (about 1/80 of a uint8 step in [-1, 1]; against JAX on the CPU it is 1e-6)
PREPROCESS_TOL = 1e-4
# (d) the unfused optimizer, accumulation 2, beside a fused AdamW fed the same gradients
CHAIN_FLAGS = ("--no-fused-adamw", "--gradient-accumulation-steps", "2")
CHAIN_TOL_LR = 1e-3  # of the learning rate, beyond the parameter's last bits: trainers/optim.py:ChainAdamW
CHAIN_TOL_REL = 2.0 ** -22
# phase 9e: staged pretrained weights and evaluation. Seeded random SD-1.5,
# Inception v3 and CLIP ViT-L/14 weights are written in the real on-disk layouts
# (STAGED: the files, each from its own generator, so that each can be made
# again to hold the loaded tensors against); the staged txt2img runs STEPS DDIM steps
STAGED = ("unet", "vae", "text_encoder", "inception", "clip_full")
STAGE_SEED = 100
EVAL_IMAGES = 32   # at 512x512, the FID and CLIP-score sets
EVAL_BATCH = 16    # the extractor's batch and CLIPScorer's default
EVAL_SHIFT = 0.5   # the shifted set: every pixel + 0.5 in [-1, 1], clipped
# card vs CPU, both in full f32 (no TF32 inside the extractor or the scorer):
# pool3 features through ~95 convs, sums in another order, of max(1, max|CPU|);
# the cosine similarities after 24 + 12 transformer layers, absolute
FID_FEATURE_TOL = 1e-4
CLIP_SIM_TOL = 1e-4
FID_SELF_RATIO = 0.01  # |FID(set, itself)| below this share of FID(set, shifted set)
# phase 9f: multi-device training on the one card, SD-1.5 width, 512x512, the
# train phase's batch, PARALLEL_STEPS optimizer steps (accumulation 1; two
# warm-up steps, the rest timed), from the staged weights (--model-dir), each
# run under torchrun --nproc_per_node 1 (NCCL) against one process with no
# flag: DDP, ZeRO and offload run the same kernels on the same data and must
# give the same bits; FSDP (other conv layouts, so other cuDNN algorithms) is
# held by the update it applied, PARALLEL_UPDATE_TOL
PARALLEL_STEPS = 8
PARALLEL_LR = 1e-4
PARALLEL_RUNS = (
    ("ddp", ("--num-devices", "1")),
    ("zero_int8", ("--shard-optimizer-state", "--use-8bit-adam")),
    ("fsdp", ("--shard-params",)),
    ("offload", ("--offload-optimizer",)),
    ("offload_int8", ("--offload-optimizer", "--use-8bit-adam")),
)
# ||d_run - d_base|| / ||d_base||, d = final - initial parameters: over all
# leaves, the median leaf's and the worst leaf's. A path that applies no
# update reads 1, one at half the learning rate 0.5, one with the wrong sign
# 2: phase 9f holds these controls against the same limits and needs each to
# fail. FSDP read 0.0023, 0.00047 and 0.015 on an H100 (PERF.md, PR 15); the
# limits stand ~7-20x above those and >= 5x below the nearest control
PARALLEL_UPDATE_TOL = {"global": 0.02, "median_leaf": 0.01, "worst_leaf": 0.1}
PARALLEL_CONTROLS = {"no_update": 0.0, "half_lr": 0.5, "wrong_sign": -1.0}
PARALLEL_LOSS_TOL = 1e-3  # FSDP's losses, relative (read: at most 5.3e-5)
PARALLEL_RESTORE = ("offload_int8",)  # the offload run that also restores its checkpoint
PARALLEL_RUNS_TIMEOUT_S = 900  # the one torchrun child that runs every configuration
PARALLEL_K9_WORLDS = (2, 4, 8)
# (phase, image size, batch, extra flags, kernels its run must launch)
TRAIN_PHASES = (
    ("train", 512, TRAIN_BATCH, (), TRAIN_KERNELS),
    ("hires_train", HIRES, HIRES_TRAIN_BATCH, (), TRAIN_KERNELS),
    ("lean_train", 512, LEAN_TRAIN_BATCH, LEAN_FLAGS, LEAN_TRAIN_KERNELS),
)
# the SD-1.5 stack (models/presets.py) as training-CLI flags
SD15_FLAGS = (
    "--channels-list 320,640,1280,1280 --n-heads 8 --attention-resolutions 1,2,4 --num-res-blocks 2 "
    "--time-emb-dim 1280 --context-dim 768 --n-layers 1 --dropout 0 "
    "--autoencoder-channels-list 128,256,512,512 --autoencoder-num-res-blocks 2 --groups 32"
).split()
TINY_FLAGS = (
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
    "--autoencoder-channels-list 16,32 --groups 8"
).split()
# the SD-1.5 VAE (models/presets.py:sd15_autoencoder_config) as training-CLI flags
SD15_VAE_FLAGS = "--autoencoder-channels-list 128,256,512,512 --autoencoder-num-res-blocks 2 --groups 32".split()


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def launch_counts() -> dict:
    """Each kernel's launches since the counts were last set to 0, and those
    of K1 at kv > 9216 (the shapes the TPU's streaming forward, K2, took)."""
    from stable_diffusion_pytorch_tpu_torch.ops import native

    counts = {name: native.COUNTERS[name].count for name in TPU_KERNELS}
    counts["flash_attention_kv_past_9216"] = sum(
        n for key, n in native.COUNTERS["flash_attention"].shapes.items() if key[2] > 9216)
    return counts


def cuda_ms(fn, iters: int = 5, repeats: int = 5, warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean CUDA-event time of ``iters`` launches,
    after ``warmup`` calls (the median keeps one host stall out of the number)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, repeats: int = 5) -> float:
    """Device time of one ``fn()``: a CUDA graph of ``calls`` calls (captured
    after 3 warm-up calls on a side stream), the median over ``repeats``
    replays of the replay's CUDA-event time over ``calls``. No host work
    between the kernels, so a small call reads its device time, not the
    wrapper's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's ~2 GHz
# kineto keeps no device record stamped outside its profile's window, and the
# device's timestamps were seen ~1.2 ms behind the host's early in a run and
# further off late in one (a late profile then lost every record of short
# calls): each profile pads the calls with ~10 ms spins on both sides, and
# doubles the pads for each profile that saw less than a kernel a call
PAD_CYCLES = 10 * SPIN_CYCLES
PLAIN_TIMING = dict(iters=1, repeats=3, warmup=1)  # a plain version's time: context, not a yardstick


def device_kernels(fn, calls: int = 2, attempts: int = 8) -> tuple:
    """({kernel name: (launches, device ms) per ``fn()``}, kernels launched
    per ``fn()``, that profile's pad in ms), both counts from the device's records of
    ``calls`` calls under torch.profiler, copies, fills and the spins aside:
    the fullest of up to ``attempts`` profiles (a profile may lose records,
    never adds one), stopping at the first that saw a kernel a call. Each
    profile spins ``pad`` cycles before the first call and after the last
    (``PAD_CYCLES``, doubled after each profile that saw less than a kernel
    a call) and ``SPIN_CYCLES`` between calls, so that no call's kernels are
    the profile's first or its last. Only the device is traced (no host
    ops: their records cost seconds to read and count nothing here)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best, best_pad, pad = {}, PAD_CYCLES, PAD_CYCLES
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(pad)
            for i in range(calls):
                fn()
                torch.cuda._sleep(SPIN_CYCLES if i + 1 < calls else pad)
            torch.cuda.synchronize()
        found = {e.key: (e.count / calls, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
                 if "cuda" in str(getattr(e, "device_type", "")).lower() and e.self_device_time_total > 0
                 and not e.key.startswith(("Memcpy", "Memset")) and "spin_kernel" not in e.key}
        if sum(n for n, _ in found.values()) > sum(n for n, _ in best.values()):
            best, best_pad = found, pad
        if sum(n for n, _ in best.values()) >= 1:
            break
        pad *= 2
    return best, sum(n for n, _ in best.values()), best_pad / SPIN_CYCLES


def fill_zero_weights(module, generator) -> None:
    """Seeded values for the weights the JAX-style init leaves at zero."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if p.dim() > 1 and not p.any():
                p.normal_(0.0, 0.5 * p[0].numel() ** -0.5, generator=generator)


def build_sd15(device, dtype, seed: int, lora=None):
    """The SD-1.5 stack from ``seed``, zero layers filled; ``lora`` =
    (factors, scale) merged into the UNet's f32 weights before the cast."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models

    model = build_models(
        presets.sd15_unet_config(), presets.sd15_autoencoder_config(), ClipConfig(model_dir=None),
        presets.sd15_ddpm_config(), dtype=dtype, device=device, seed=seed, lora=lora,
    )
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for m in (model.unet, model.autoencoder):
        fill_zero_weights(m, gen)
    return model


def train_argv(work: str, *flags: str):
    return ["--device", "cuda", "--dataset", "synthetic", "--seed", str(SEED),
            "--logging-dir", os.path.join(work, "logs"), "--ckpt-dir", os.path.join(work, "ckpt"), *flags]


def build_sd15_trainer(work: str, resolution: int, batch: int, flags=()):
    """The training entry point's trainer at SD-1.5 width."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    shutil.rmtree(work, ignore_errors=True)
    trainer = build_trainer(train_argv(
        work, *SD15_FLAGS, "--resolution", str(resolution), "--train-batch-size", str(batch),
        "--eval-batch-size", str(batch), "--max-train-steps", str(TRAIN_STEPS), "--lr-warmup-steps", "0",
        "--learning-rate", "1e-4", "--max-train-samples", str(16 * batch), "--max-val-samples", str(batch),
        "--log-interval", str(TRAIN_STEPS), "--dataloader-num-workers", "4", *flags,
    ))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    fill_zero_weights(trainer.model.unet, gen)
    fill_zero_weights(trainer.model.autoencoder, gen)
    return trainer


def build_sd15_vae_trainer(work: str, resolution: int, batch: int, flags=()):
    """The autoencoder training entry point's trainer at the SD-1.5 VAE's width."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder import build_trainer

    shutil.rmtree(work, ignore_errors=True)
    trainer = build_trainer(train_argv(
        work, *SD15_VAE_FLAGS, "--resolution", str(resolution), "--train-batch-size", str(batch),
        "--eval-batch-size", str(batch), "--max-train-steps", str(TRAIN_STEPS), "--lr-warmup-steps", "0",
        "--learning-rate", "1e-4", "--max-train-samples", str(16 * batch), "--max-val-samples", str(batch),
        "--max-test-samples", "2", "--log-interval", str(TRAIN_STEPS), "--dataloader-num-workers", "4", *flags,
    ))
    fill_zero_weights(trainer.vae, torch.Generator(device="cuda").manual_seed(SEED + 1))
    return trainer


def _png_file(path: str):
    """RGB uint8 pixels of a PNG the port wrote: the image reader of the
    DreamBooth folders here, where Pillow may be missing."""
    with open(path, "rb") as f:
        return _png_pixels(f.read())[..., :3]


def build_personalize_trainer(kind: str, work: str, class_steps: int = STEPS):
    """One personalization entry point's trainer at SD-1.5 width, 512x512,
    through its ``build_trainer``: ``dreambooth_lora`` (``--lora-rank 8
    --with-prior-preservation --use-8bit-adam``; 16 instance PNGs written
    from ``smoke_image``, the 4 class images sampled by ``ensure_class_images``
    in ``class_steps`` DDIM steps; the folders read without Pillow),
    ``textual_inversion`` (two vectors from ``toy``) or ``controlnet``
    (synthetic rows, edge hints). The UNet's and VAE's zero layers are filled
    after the build, and the ControlNet copies the filled encoder; its own
    zero convs stay at zero."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.models.controlnet import init_controlnet_from_unet
    from stable_diffusion_pytorch_tpu_torch.utils.data import to_img

    shutil.rmtree(work, ignore_errors=True)
    flags = [*SD15_FLAGS, "--resolution", str(PERSONALIZE_SIZE), "--max-train-steps", str(TRAIN_STEPS),
             "--lr-warmup-steps", "0",
             "--learning-rate", "1e-4", "--adam-weight-decay", "0", "--log-interval", str(TRAIN_STEPS),
             "--checkpointing-steps", str(TRAIN_STEPS), "--dataloader-num-workers", "4",
             "--eval-batch-size", str(PERSONALIZE_BATCH)]
    if kind == "dreambooth_lora":
        from stable_diffusion_pytorch_tpu_torch.scripts.train_dreambooth import build_trainer

        inst = os.path.join(work, "instance")
        for i in range(NUM_INSTANCE_IMAGES):
            to_img(smoke_image(10 + i, PERSONALIZE_SIZE), inst, f"instance_{i:02d}.png")
        trainer = build_trainer(train_argv(
            work, *flags, "--train-batch-size", str(PERSONALIZE_BATCH // 2), "--instance-data-dir", inst,
            "--instance-prompt", "a photo of sks toy", "--with-prior-preservation",
            "--class-data-dir", os.path.join(work, "class"), "--class-prompt", "a photo of a toy",
            "--num-class-images", str(NUM_CLASS_IMAGES), "--class-sampling-steps", str(class_steps),
            "--lora-rank", str(LORA_RANK), "--use-8bit-adam"), read=_png_file)
    else:
        data = ["--train-batch-size", str(PERSONALIZE_BATCH), "--max-train-samples", str(16 * PERSONALIZE_BATCH),
                "--max-val-samples", str(PERSONALIZE_BATCH)]
        if kind == "textual_inversion":
            from stable_diffusion_pytorch_tpu_torch.scripts.train_textual_inversion import build_trainer

            data += ["--placeholder-token", "<concept>", "--num-vectors", "2", "--initializer-token", "toy"]
        else:
            from stable_diffusion_pytorch_tpu_torch.scripts.train_controlnet import build_trainer
        trainer = build_trainer(train_argv(work, *flags, *data))
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 1)
    fill_zero_weights(trainer.model.unet, gen)
    fill_zero_weights(trainer.model.autoencoder, gen)
    if kind == "controlnet":
        check(trainer.state.ema_params is None, "the ControlNet run keeps no EMA to re-copy")
        init_controlnet_from_unet(trainer.model.unet, trainer.controlnet)
    return trainer


def free_cuda() -> float:
    """Collect garbage, return cached blocks; -> GB still allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def phase_env() -> dict:
    import torch

    # every kernel module, so that each launch counter exists from the start
    from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update, flash_attention, fused_groupnorm  # noqa: F401
    from stable_diffusion_pytorch_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    info = {
        "phase": "env", "gpu": gpu_line(), "device": torch.cuda.get_device_name(0),
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "cuda_build_s": build_s,
    }
    emit(info)
    return info


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version, its library call and its bound
# --------------------------------------------------------------------------- #


def _elem(dtype) -> int:
    return 4 if dtype == "float32" else 2


# The plain attention versions hold f32 [B, H, N, M] scores (the backward about
# three such); past this many elements they run one (batch, head) at a time
# (one head's scores at 16384 tokens: 2^28 elements, 1 GiB).
PLAIN_SCORES_MAX = 2 ** 30


def _per_head(plain, *tensors, scale):
    """``plain`` on one (batch, head) slice of [B, L, H, D] tensors at a time,
    written into whole outputs: the same math, row by row."""
    b, h = tensors[0].shape[0], tensors[0].shape[2]
    outs = None
    for i in range(b):
        for j in range(h):
            parts = plain(*(t[i:i + 1, :, j:j + 1] for t in tensors), scale)
            parts = parts if isinstance(parts, tuple) else (parts,)
            if outs is None:
                outs = [p.new_empty((b, p.shape[1], h, p.shape[3])) for p in parts]
            for o, p in zip(outs, parts):
                o[i:i + 1, :, j:j + 1] = p
    return outs[0] if len(outs) == 1 else tuple(outs)


def _plain_attn(plain, key, *tensors, scale):
    """(the plain version as a callable, whether it runs per (batch, head))."""
    b, n, m, h, _ = key
    if b * h * n * m > PLAIN_SCORES_MAX:
        return (lambda: _per_head(plain, *tensors, scale=scale)), True
    return (lambda: plain(*tensors, scale)), False


def _attn_case(key, dtype, gen):
    """K1 at [B, N, M, H, D]: (kernel, plain, library, flops, bytes, record)."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, n, m, h, d = key
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(getattr(torch, dtype)) for s in (n, m, m))
    scale = d ** -0.5
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    plain, per_head = _plain_attn(flash_attention_plain, key, q, k, v, scale=scale)
    return (
        lambda: flash_attention(q, k, v, scale),
        plain,
        lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
        4 * b * h * n * m * d,
        _elem(dtype) * (2 * b * n * h * d + 2 * b * m * h * d),
        {"plain_per_head": per_head, "compare": _own_scale_err if dtype == "bfloat16" else None},
    )


def _attn_bwd_case(key, dtype, gen, split: bool = False):
    """K3 (or, with ``split``, K4/K5) at [B, N, M, H, D], given the K1
    forward's output and lse. Both bounds count the 10 B H N M D FLOPs of
    the five products the gradient needs, so the two rows compare."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (
        _forward_kernel,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_bwd_split,
    )

    b, n, m, h, d = key
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt) for s in (n, m, m, n))
    scale = d ** -0.5
    out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    do_h = do.transpose(1, 2)
    kernel = flash_attention_bwd_split if split else flash_attention_bwd
    plain, per_head = _plain_attn(flash_attention_bwd_plain, key, q, k, v, do, scale=scale)
    return (
        lambda: kernel(q, k, v, out, do, lse, scale),
        plain,
        lambda: torch.autograd.grad(lib_out, leaves, do_h, retain_graph=True),
        10 * b * h * n * m * d,
        _elem(dtype) * 4 * (b * n * h * d + b * m * h * d),
        {"plain_per_head": per_head, "compare": _own_scale_err if dtype == "bfloat16" else None},
    )



def _gn_inputs(shape, c, gen, offset=0.5):
    import torch

    x = torch.randn(*shape, device="cuda", generator=gen) * 2.0 + offset
    w = 1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)
    b = 0.3 * torch.randn(c, device="cuda", generator=gen)
    return x, w, b


def _torch_gn(x, w, b, g, silu, eps=1e-5):
    """F.group_norm (+ F.silu) on a channel-last [B, S, C] map."""
    import torch.nn.functional as F

    y = F.group_norm(x.transpose(1, 2), g, w.to(x.dtype), b.to(x.dtype), eps)
    return F.silu(y) if silu else y


def _gn_case(key, dtype, gen):
    """K6 at [B, S, C, groups, silu, eps] (eps as the path launched it: 1e-6
    in the diffusers VAE, 1e-5 elsewhere)."""
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm

    import torch

    b, s, c, g, silu, eps = key
    x, w, bias = _gn_inputs((b, s, c), c, gen)
    x = x.to(getattr(torch, dtype))
    return (
        lambda: fused_group_norm(x, w, bias, g, eps, silu),
        lambda: xla_group_norm(x, w, bias, g, eps, silu),
        lambda: _torch_gn(x, w, bias, g, silu, eps),
        (12 if silu else 8) * x.numel(),
        _elem(dtype) * 2 * x.numel(),
    )


def _gn_cat_case(key, dtype, gen):
    """K8 at [B, S, C1, C2, groups, silu]."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm_cat
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm_cat

    b, s, c1, c2, g, silu = key
    x, w, bias = _gn_inputs((b, s, c1), c1 + c2, gen)
    skip = (_gn_inputs((b, s, c2), c2, gen, offset=-1.0)[0] * 1.5).to(getattr(torch, dtype))
    x = x.to(getattr(torch, dtype))
    n = x.numel() + skip.numel()
    return (
        lambda: fused_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
        lambda: xla_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
        lambda: _torch_gn(torch.cat([x, skip], dim=-1), w, bias, g, silu),
        (12 if silu else 8) * n,
        _elem(dtype) * 2 * n,
    )


def _gn_bwd_case(key, dtype, gen):
    """K7 at [B, S, C1, C2, groups, silu] (C2 > 0: the concat form's
    backward), given the K6/K8 forward's statistics."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (
        _forward,
        group_norm_bwd,
        group_norm_bwd_plain,
    )

    b, s, c1, c2, g, silu = key
    dt = getattr(torch, dtype)
    x, w, bias = _gn_inputs((b, s, c1), c1 + c2, gen)
    parts = [x.to(dt)]
    if c2:
        parts.append((_gn_inputs((b, s, c2), c2, gen, offset=-1.0)[0] * 1.5).to(dt))
    dy = torch.randn(b, s, c1 + c2, device="cuda", generator=gen).to(dt)
    _, mean, rstd = _forward(parts[0], parts[1] if c2 else None, w, bias, g, 1e-5, silu)
    leaves = [t.detach().requires_grad_(True) for t in (*parts, w, bias)]
    whole = torch.cat(leaves[:len(parts)], dim=-1) if c2 else leaves[0]
    lib_out = _torch_gn(whole, leaves[-2], leaves[-1], g, silu)
    dy_t = dy.transpose(1, 2)
    n = b * s * (c1 + c2)
    return (
        lambda: group_norm_bwd(parts, dy, w, bias, mean, rstd, g, 1e-5, silu),
        lambda: group_norm_bwd_plain(parts, dy, w, bias, g, 1e-5, silu),
        lambda: torch.autograd.grad(lib_out, leaves, dy_t, retain_graph=True),
        (24 if silu else 16) * n,
        _elem(dtype) * 3 * n,
    )


ADAM_BC = (1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3)  # bias corrections at step 3


def _adam_state(shape, gen):
    """Seeded non-zero (g scale 0.02, mu, sqrt(nu)) int8 state of one leaf in the
    main path's layout (4-D conv weights channels_last, as the trainer keeps them)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import quantize

    fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format

    def state(x):
        q, sc = quantize(x, 256)
        return q.contiguous(memory_format=fmt), sc.contiguous(memory_format=fmt)

    mu = state(torch.randn(shape, device="cuda", generator=gen) * 0.01)
    nu = state((torch.randn(shape, device="cuda", generator=gen).abs() * 1e-4).sqrt())
    return mu, nu, fmt


def _adam_case(key, dtype, gen):
    """K9 at one parameter shape, from step-3 state: (kernel, plain, library
    (none), FLOPs, bytes, record). Bytes: g and the update once each in the
    gradient's dtype, two codes read and written, two f32 scales read and
    written; about 30 f32 operations per element (bound by bytes)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import (
        adam8bit_update,
        adam8bit_update_plain,
        blocked_layout,
    )

    shape = tuple(key)
    mu, nu, fmt = _adam_state(shape, gen)
    g = (torch.randn(shape, device="cuda", generator=gen) * 0.02).to(getattr(torch, dtype))
    g = g.contiguous(memory_format=fmt)
    bc1, bc2 = (float(torch.tensor(b, dtype=torch.float32)) for b in ADAM_BC)
    n = g.numel()
    _, r, _, nb = blocked_layout(shape, 256)
    return (
        lambda: adam8bit_update(g, mu, nu, bc1, bc2),
        lambda: adam8bit_update_plain(g, mu, nu, bc1, bc2, 0.9, 0.999, 1e-8, 256),
        None,
        30 * n,
        2 * _elem(dtype) * n + 4 * n + 16 * nb * r,
        {"compare": _adam_compare, "peak": "float32"},
    )


def _adam_compare(out, ref):
    """K9 vs plain -> (max-abs update error, worst ratio to its limit, record):
    the update at rtol 1e-6 / atol 1e-7 in f32 (one bf16 ulp, rtol 2^-8, when
    it is bf16: an f32 value within an ulp of a bf16 rounding midpoint may
    round either way); codes at most one apart at no more than max(1, n /
    10^4) places (a value on a rounding boundary); dequantized moments at rtol
    1e-5 / atol 1e-8 where the codes agree. Both sides do the same IEEE
    operations in the same order, so all of it is expected to be exact."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import dequantize

    rtol = 1e-6 if out[0].dtype == torch.float32 else 2.0 ** -8
    upd, r_upd = out[0].float(), ref[0].float()
    d = (upd - r_upd).abs()
    ratios = [(d / (1e-7 + rtol * r_upd.abs())).max().item()]
    rec = {"update_max_abs_err": d.max().item(), "update_bitwise_equal": bool(torch.equal(out[0], ref[0]))}
    for name, ours, theirs in (("mu", out[1], ref[1]), ("nu", out[2], ref[2])):
        diff = (ours[0].int() - theirs[0].int()).abs()
        n_diff, n = int((diff > 0).sum()), diff.numel()
        got, want = dequantize(*ours), dequantize(*theirs)
        deq = ((got - want).abs() / (1e-8 + 1e-5 * want.abs()))[diff == 0]
        ratios += [int(diff.max()) / 1.0, n_diff / max(1, n // 10 ** 4), deq.max().item() if deq.numel() else 0.0]
        rec.update({f"{name}_codes_differ": n_diff, f"{name}_codes_max_diff": int(diff.max()),
                    f"{name}_dequant_max_rel_err": ((got - want).abs() / want.abs().clamp(min=1e-30)).max().item()})
    return rec["update_max_abs_err"], max(ratios), rec


def sd15_leaves(leaf_shapes, seed: int, state: bool = True):
    """The SD-1.5 UNet's leaves in the trainer's shapes and layouts (conv
    weights channels_last), seeded: (shapes, f32 parameters, gradients by
    dtype, mu, nu), the int8 state non-zero (``_adam_state``) or None."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [shape for shape, n in sorted(leaf_shapes.items()) for _ in range(n)]

    def leaf(shape, scale):
        t = torch.randn(shape, device="cuda", generator=gen) * scale
        return t.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else t

    params = [leaf(shape, 0.02) for shape in shapes]
    grads = {"float32": [leaf(shape, 1e-3) for shape in shapes]}
    grads["bfloat16"] = [g.to(torch.bfloat16) for g in grads["float32"]]  # keeps each layout
    mu = nu = None
    if state:
        mu, nu = map(list, zip(*((m, n) for m, n, _ in (_adam_state(shape, gen) for shape in shapes))))
    return shapes, params, grads, mu, nu


def _state_copy(params, mu, nu):
    return ([p.clone() for p in params], [tuple(t.clone() for t in m) for m in mu],
            [tuple(t.clone() for t in n) for n in nu])


def adam_step_record(leaf_shapes) -> dict:
    """K9 as the trainer launches it: one launch over the SD-1.5 UNet's 686
    leaves with the clip and the apply fused in (``Adam8bitStep``), from
    seeded non-zero state at step 3, f32 and bf16 gradients, the clip active
    (limit half the norm) and not (twice it), against
    ``adam8bit_step_plain`` on the card from the same state: parameters,
    codes and scales must be bit-identical, and the step one device kernel.
    Bytes of the bound: g once (4 or 2 B), both codes read and written (4
    B), p read and written (8 B) per parameter, the f32 scales read and
    written; about 40 f32 operations per parameter at the f32 peak."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import (
        Adam8bitStep,
        adam8bit_plan,
        adam8bit_step_plain,
    )
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm

    shapes, params, grads, mu, nu = sd15_leaves(leaf_shapes, seed=5)
    bc1, bc2 = (float(torch.tensor(b, dtype=torch.float32)) for b in ADAM_BC)
    lr, wd = float(torch.tensor(1e-4, dtype=torch.float32)), 0.1
    plan = adam8bit_plan(shapes, 256)
    n = sum(p.numel() for p in params)
    n_scales = sum(leaf.nb * leaf.r for leaf in plan.leaves)
    cases, failures, control = [], [], None
    for dname, g in grads.items():
        norm = global_norm(g)
        for clip in (True, False):
            limit = float(norm) * (0.5 if clip else 2.0)
            fused, plain = _state_copy(params, mu, nu), _state_copy(params, mu, nu)
            step = Adam8bitStep(*fused, 256)

            def run_fused():
                step(g, norm, bc1, bc2, lr, 0.9, 0.999, 1e-8, wd, limit)

            def run_plain():
                adam8bit_step_plain(plain[0], g, plain[1], plain[2], norm, bc1, bc2, lr, 0.9, 0.999, 1e-8, wd,
                                    limit, 256)

            run_fused()
            run_plain()
            torch.cuda.synchronize()
            differ = {"params": sum(not torch.equal(a, b) for a, b in zip(fused[0], plain[0]))}
            states = list(zip(fused[1] + fused[2], plain[1] + plain[2]))
            for name, i in (("codes", 0), ("scales", 1)):
                differ[name] = sum(not torch.equal(a[i], b[i]) for a, b in states)
            err = max((a - b).abs().max().item() for a, b in zip(fused[0], plain[0]))
            kernels, launches, pad_ms = device_kernels(run_fused)
            ms = cuda_ms(run_fused)
            plain_ms = cuda_ms(run_plain, iters=1, repeats=1, warmup=0)  # ~1 s a call; it ran just above
            nbytes = n * (_elem(dname) + 2 + 2 + 4 + 4) + 16 * n_scales
            bound_ms, bound_by = _bound(40 * n, nbytes, "float32")
            rec = {"dtype": dname, "clip_active": clip, "n_leaves": len(shapes), "n_params": n,
                   "n_items": len(plan.items), "leaves_differ": differ, "max_abs_err": err,
                   "device_kernels": {k: count for k, (count, _) in kernels.items()}, "launches_per_call": launches,
                   "profile_pad_ms": pad_ms,
                   "device_ms": sum(t for _, t in kernels.values()), "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "library_ms": None}
            rec["ok"] = not any(differ.values()) and one_k9_launch(kernels, launches)
            cases.append(rec)
            if not rec["ok"]:
                failures.append(rec)
            if dname == "bfloat16" and clip:
                control = elided_launch_control(step, g, norm, limit, wd)
                if control["check_passes"]:
                    failures.append({"elided_launch_control": control})
            del fused, plain, step
            free_cuda()
    del params, grads, mu, nu
    free_cuda()
    return {"cases": cases, "elided_launch_control": control, "failures": failures}


def one_k9_launch(kernels: dict, launches: float) -> bool:
    """The step's check: one device kernel a call, and it is K9's."""
    k9 = sum(n for name, (n, _) in kernels.items() if "adam8bit_step_kernel" in name)
    return launches == 1 and k9 == 1


def elided_launch_control(step, g, norm, limit: float, wd: float) -> dict:
    """The K9 step as a wrapper whose launch is elided: it counts its launch
    and issues it into a CUDA graph that is never replayed, so the host's
    runtime records a kernel launch that the device never runs (capturing
    also runs the graph's own two fill kernels). The device count must fail
    the step's check (``one_k9_launch``)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update as k9

    def elided():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            k9._launch(g[0].dtype, step.params[0].device, step._table, step.plan, step._words, norm, limit, 0.9,
                       0.999, 1e-8, wd)
        k9.LAUNCHES.hit(("step", len(step.params), len(step.plan.items), str(g[0].dtype)))

    before = k9.LAUNCHES.count
    kernels, launches, _ = device_kernels(elided)
    return {"counted": k9.LAUNCHES.count - before, "device_kernels": {k: n for k, (n, _) in kernels.items()},
            "launches_per_call": launches, "check_passes": one_k9_launch(kernels, launches)}


# Tolerances on max|kernel - plain| of each output, relative to max(1, max|plain|)
# of that output (bf16 attention: to max|plain|, ``_own_scale_err``):
# float32 -- another summation order over at most a few thousand terms (the
# backward: sums over up to 4096 kv or 40960 map rows; K3 adds dQ's shares
# over kv blocks in a fixed order, the split set sums it in one block);
# bfloat16 -- both sides round outputs (and attention's P and dS) to bf16,
# whose spacing is 2^-8 to 2^-7 of the magnitude, so a few ulps; a kv tile of
# 64 dropped at 16384 kv moves an attention output by ~3-6 % of its magnitude
# (tests/test_torch_port_attention_bf16.py). Both backward routes take delta
# from the stats pass, an f32 sum of P * dP as the plain version's. The split
# backward (K4/K5) sums over up to 16384 rows; the same limits as K3.
TOLERANCE = {
    "flash_attention": {"float32": 1e-5, "bfloat16": 2e-2},
    "flash_attention_bwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "flash_attention_bwd_split": {"float32": 1e-4, "bfloat16": 2e-2},
    "group_norm": {"float32": 5e-5, "bfloat16": 2e-2},
    "group_norm_bwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "group_norm_cat": {"float32": 5e-5, "bfloat16": 2e-2},
    # K9: its comparison (_adam_compare) returns the worst ratio to its own limits
    "adam8bit_update": {"float32": 1.0, "bfloat16": 1.0},
}
CASES = {"flash_attention": _attn_case, "flash_attention_bwd": _attn_bwd_case,
         "flash_attention_bwd_split": functools.partial(_attn_bwd_case, split=True),
         "group_norm": _gn_case, "group_norm_bwd": _gn_bwd_case, "group_norm_cat": _gn_cat_case,
         "adam8bit_update": _adam_case}


class _NoUpdate:
    """An optimizer for the shape probe: takes the gradients, applies nothing."""

    def step(self, grads):
        import torch

        return False, torch.zeros(())


def record_shapes(model, work: str, stage: str):
    """The distinct launch shapes of each kernel: one-step runs of txt2img at
    512x512 and at 1024x1024, of the hires fix (a one-step base and a
    one-step refine), of the server's buckets of 2 and 4 requests at
    512x512 (the samplers phase runs the slice's shapes), of a weighted
    2-chunk prompt and of img2img at 512x512 (the features phase's new
    shapes: K1 at kv 154, the VAE encoder), and one training
    micro step of each train phase's trainer and of the VAE trainer
    (parameters untouched), each trainer built for its probe and freed
    after it, and phase 9e's (``eval_probes``: the staged diffusers VAE's
    decode, a CLIP-score batch). K3 is held at the backward shapes the
    JAX crossover sends to it (kv up to 9216), which bf16 training runs on the
    split set, and at the f32 VAE parity's; the split set also at the 512px
    VAE bottleneck (``EXTRA_BWD_SHAPES``); K9 at every parameter shape of the
    lean trainer's UNet. -> (shapes by kernel, the count of UNet leaves of
    each parameter shape)."""
    import collections

    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    shapes = {name: set() for name in TPU_KERNELS}

    def collect():
        torch.cuda.synchronize()
        for name in TPU_KERNELS:
            shapes[name] |= {k[:-1] for k in native.COUNTERS[name].shapes}
        native.reset_counters()

    native.reset_counters()
    with torch.inference_mode():
        for size, hires in ((512, {}), (HIRES, {}),
                            (HIRES_BASE, {"hires_scale": 2.0, "hires_strength": 0.6, "vae_tile": HIRES_TILE})):
            pipeline.sample(model, image_size=size, prompt="a photo of a cat", time_steps=1,
                            guidance_scale=7.5, save_dir=None, num_images=NUM_IMAGES, seed=0, **hires)
            collect()
        # the server's larger buckets (1 is the slice's): UNet batch 4 and 8 with CFG
        for bucket in SERVE_BUCKETS[1:]:
            pipeline.sample(model, image_size=512, prompt=["a photo of a cat"] * bucket, time_steps=1,
                            guidance_scale=7.5, save_dir=None, seed=list(range(bucket)))
            collect()
        # the features' own shapes: K1 at kv 154 (a 2-chunk prompt), the VAE
        # encoder's (img2img; inpaint's are the same; ControlNet and DeepCache
        # run the UNet's)
        pipeline.sample(model, image_size=512, prompt=weighted_long_prompt(model), time_steps=1, guidance_scale=7.5,
                        save_dir=None)
        collect()
        pipeline.img2img(model, smoke_image(1), prompt="a photo of a cat", strength=1.0, image_size=512,
                         time_steps=1, guidance_scale=7.5, save_dir=None)
        collect()
    leaf_shapes = None
    for name, size, batch, flags, _required in TRAIN_PHASES:
        trainer = build_sd15_trainer(f"{work}_{name}_probe", size, batch, flags)
        batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
        probe = TrainState(trainer.model.unet, _NoUpdate())
        trainer._train(probe, batch_in, trainer.uncond_ids, trainer._draws(batch_in, step_generator("cuda", 9)))
        collect()
        if name == "lean_train":
            leaf_shapes = collections.Counter(tuple(p.shape) for p in trainer.state.params)
        del trainer, probe, batch_in
        free_cuda()
    trainer = build_sd15_vae_trainer(f"{work}_vae_train_probe", VAE_TRAIN, VAE_TRAIN_BATCH)
    batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
    probe = TrainState(trainer.vae, _NoUpdate())
    trainer._train(probe, batch_in, trainer._eps(batch_in, step_generator("cuda", 9)))
    collect()
    del trainer, probe, batch_in
    free_cuda()
    lora_leaf_shapes = personalize_probes(work, collect)
    train_options_probes(model, work, collect)
    eval_probes(stage, collect)
    # K3's shapes: the backward shapes the JAX crossover sends to it (bf16
    # training now runs the split set at every length, backward_route)
    shapes["flash_attention_bwd"] |= {k for k in shapes["flash_attention_bwd_split"]
                                      if -(-k[2] // 128) * 128 <= KV_RESIDENT_MAX}
    for name, extra in EXTRA_BWD_SHAPES.items():
        shapes[name] |= extra
    shapes["flash_attention_bwd_split"] |= shapes["flash_attention_bwd"]
    shapes["adam8bit_update"] = set(leaf_shapes) | set(lora_leaf_shapes)
    return {name: sorted(v) for name, v in shapes.items()}, leaf_shapes, lora_leaf_shapes


def train_options_probes(model, work: str, collect):
    """Phase 9d's new launch shapes, ``collect()`` after each: the latent
    cache's encoder at its batch (``build_latent_cache`` over ``CACHE_ROWS``
    synthetic rows at 512x512, on the slice's bf16 VAE and CLIP), one micro
    step of run (a) (the gradient-noise-scale split: the UNet, the VAE
    encoder and their backward at half the batch), of (c)'s UNet trainer at
    256x256 and of (c)'s VAE trainer (the split at 256x256), each with an
    optimizer that applies nothing, built and freed."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator
    from stable_diffusion_pytorch_tpu_torch.utils.data import DatasetConfig, SyntheticTextImageDataset
    from stable_diffusion_pytorch_tpu_torch.utils.latent_cache import build_latent_cache

    rows = SyntheticTextImageDataset(DatasetConfig(dataset="synthetic", resolution=512), "train",
                                     model.text_encoder.tokenizer, CACHE_ROWS)
    with torch.inference_mode():
        build_latent_cache(model.autoencoder, rows, os.path.join(f"{work}_cache_probe", "latents.npz"),
                           text_encoder=model.text_encoder)
    collect()
    for build, size, flags, halves in (
            (build_sd15_trainer, 512, OBJECTIVE_FLAGS, True),
            (build_sd15_trainer, PREPROCESS_SIZE, PREPROCESS_FLAGS, False),
            (build_sd15_vae_trainer, PREPROCESS_SIZE, (*PREPROCESS_FLAGS, "--log-grad-noise-scale"), True)):
        trainer = build(f"{work}_options_probe", size, TRAIN_BATCH, flags)
        batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
        own = trainer.state
        trainer.state = TrainState(own.module, _NoUpdate())
        check(trainer.gns == halves, f"the probe's gradient-noise-scale switch is {trainer.gns}")
        trainer._train_step(batch_in, step_generator("cuda", 9))
        collect()
        del trainer, own, batch_in
        free_cuda()


def personalize_probes(work: str, collect):
    """One micro step of each personalization trainer (phase 9c's), with an
    optimizer that applies nothing, each built (the DreamBooth class images
    sampled in one step) and freed; ``collect()`` after each. -> the count of
    the LoRA trainer's leaves of each shape (K9's leaves there)."""
    import collections

    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    lora_leaf_shapes = None
    for kind in PERSONALIZE_RUNS:
        trainer = build_personalize_trainer(kind, f"{work}_{kind}_probe", class_steps=1)
        batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
        own = trainer.state
        trainer.state = TrainState(own.trainables or own.module, _NoUpdate())
        trainer._train_step(batch_in, step_generator("cuda", 9))
        collect()
        if kind == "dreambooth_lora":
            lora_leaf_shapes = collections.Counter(tuple(p.shape) for p in own.params)
        del trainer, own, batch_in
        free_cuda()
    return lora_leaf_shapes


def _bound(flops: float, nbytes: float, dtype: str):
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _max_err(out, ref, floor: float = 1.0):
    """(max-abs error, max over outputs of error / max(floor, max|plain output|),
    {"scale": each output's max(floor, max|plain|)})."""
    pairs = list(zip(_flat(out), _flat(ref))) if isinstance(out, (list, tuple)) else [(out, ref)]
    errs = [((o.float() - r.float()).abs().max().item(), max(floor, r.float().abs().max().item())) for o, r in pairs]
    return max(e for e, _ in errs), max(e / s for e, s in errs), {"scale": [s for _, s in errs]}


# bf16 attention outputs are held to their own magnitude (no floor of 1): at
# long kv they are ~0.01-0.1, where a floor would let a dropped kv tile pass
_own_scale_err = functools.partial(_max_err, floor=0.0)


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


def _attention_groups(rows, shapes) -> dict:
    """bf16 sums of K1 at kv <= 9216 and at the K2 shapes, and of the split
    backward at the VAE's head dim 512, at K3's other shapes (K4's domain)
    and at its own."""
    k3 = {tuple(k) for k in shapes.get("flash_attention_bwd", [])}
    groups = {}
    for row in rows:
        if row["dtype"] != "bfloat16":
            continue
        if row["k"] == "flash_attention":
            name = "flash_attention kv>9216" if row["shape"][2] > 9216 else "flash_attention kv<=9216"
        elif row["k"] == "flash_attention_bwd_split" and row["shape"][4] > 160:
            name = "flash_attention_bwd_split at D 512 (VAE)"
        elif row["k"] == "flash_attention_bwd_split":
            name = f"flash_attention_bwd_split at {'K3' if tuple(row['shape']) in k3 else 'its own'} shapes"
        else:
            continue
        acc = groups.setdefault(name, {"n": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
        acc["n"] += 1
        for field in ("ms", "plain_ms", "library_ms", "bound_ms"):
            acc[field] += row[field] or 0.0
    return groups


def hold_shape(name: str, key, dname: str, gen, wall=None) -> tuple:
    """Kernel ``name`` at launch shape ``key`` in ``dname`` against its plain
    version on the same inputs -> (its record, whether it passed): the error
    within ``TOLERANCE``, the implementation ``EXPECTED_IMPL`` names, the
    bits of a second launch where ``REPEAT_IDENTICAL`` asks, one device
    kernel a call where ``ONE_LAUNCH`` asks. With ``wall`` (seconds by
    activity, added to), also the kernel's, the plain version's and the
    library call's times, K6-K8's ``graph_ms`` and the bound."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    kernel, plain, library, flops, nbytes, *record = CASES[name](key, dname, gen)
    record = dict(record[0]) if record else {}
    compare = record.pop("compare", None)
    counter = native.COUNTERS[name]
    before = dict(counter.impls)
    out = kernel()
    ran = sorted(k for k, n in counter.impls.items() if n > before.get(k, 0))
    impl = ran[0] if len(ran) == 1 else (ran or None)
    ref = plain()
    # the attention backward sums in a fixed order: a second launch must agree bit for bit
    again = kernel() if name in REPEAT_IDENTICAL else out
    torch.cuda.synchronize()
    err, rel, *detail = compare(out, ref) if compare else _max_err(out, ref)
    record.update(detail[0] if detail else {})
    identical = again is out or all(torch.equal(a, b) for a, b in zip(_flat([again]), _flat([out])))
    tol = TOLERANCE[name][dname]
    del out, ref, again
    t0 = time.perf_counter()
    if name in ONE_LAUNCH:
        _, record["device_launches"], record["profile_pad_ms"] = device_kernels(kernel)
        if dname == "bfloat16" and wall is not None:
            record["graph_ms"] = graph_ms(kernel)
    bound_ms, bound_by = _bound(flops, nbytes, record.pop("peak", dname))
    row = {"k": name, "shape": list(key), "dtype": dname, "impl": impl, "err": err, "rel_err": rel, "tol": tol,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes, "repeat_identical": identical,
           **record}
    if wall is not None:
        t1 = time.perf_counter()
        row["ms"] = cuda_ms(kernel)
        t2 = time.perf_counter()
        row["plain_ms"] = cuda_ms(plain, **PLAIN_TIMING)
        t3 = time.perf_counter()
        row["library_ms"] = None if library is None else cuda_ms(library)
        t4 = time.perf_counter()
        for part, dt in (("profiles", t1 - t0), ("kernel_ms", t2 - t1), ("plain_ms", t3 - t2),
                         ("library_ms", t4 - t3)):
            wall[part] += dt
    ok = (rel <= tol and identical and impl == EXPECTED_IMPL.get(name, {}).get(dname)
          and record.get("device_launches", 1) == 1)
    return row, ok


def phase_kernels(shapes: dict, leaf_shapes, lora_leaf_shapes) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures = [], []
    wall = collections.defaultdict(float)  # seconds by activity
    t_phase = time.perf_counter()
    summary = {name: {"max_rel_err": {}, "impl": {}, "ms_bf16": 0.0, "plain_ms_bf16": 0.0, "library_ms_bf16": 0.0,
                      "bound_ms_bf16": 0.0, "ops_bound_ms_bf16": 0.0, "bytes_bound_ms_bf16": 0.0,
                      "max_abs_err_bf16": 0.0}
               for name in TPU_KERNELS}
    for name, keys in shapes.items():
        for key in keys:
            for dname in ("float32", "bfloat16"):
                row, ok = hold_shape(name, key, dname, gen, wall)
                rows.append(row)
                s = summary[name]
                s["max_rel_err"][dname] = max(s["max_rel_err"].get(dname, 0.0), row["rel_err"])
                if dname == "bfloat16":
                    s["ms_bf16"] += row["ms"]
                    s["plain_ms_bf16"] += row["plain_ms"]
                    s["library_ms_bf16"] = (None if row["library_ms"] is None
                                            else s["library_ms_bf16"] + row["library_ms"])
                    s["bound_ms_bf16"] += row["bound_ms"]
                    s["ops_bound_ms_bf16" if row["bound_by"] == "operations" else "bytes_bound_ms_bf16"] += \
                        row["bound_ms"]
                    s["max_abs_err_bf16"] = max(s["max_abs_err_bf16"], row["err"])
                    if "graph_ms" in row:
                        s["graph_ms_bf16"] = s.get("graph_ms_bf16", 0.0) + row["graph_ms"]
                if EXPECTED_IMPL.get(name, {}).get(dname):
                    s["impl"][dname] = row["impl"]
                if not ok:
                    failures.append(row)
            torch.cuda.empty_cache()
    # K9 as the main path launches it: the whole step in one launch; its bf16
    # (clip active) numbers stand for K9 in the summary, the one-leaf sums beside them
    wall["shapes"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    step = adam_step_record(leaf_shapes)
    failures += step["failures"]
    # and over the DreamBooth LoRA's factor leaves, as its trainer launches it
    lora_step = adam_step_record(lora_leaf_shapes)
    failures += lora_step["failures"]
    wall["adam8bit_steps"] = time.perf_counter() - t0
    s = summary["adam8bit_update"]
    main = next(c for c in step["cases"] if c["dtype"] == "bfloat16" and c["clip_active"])
    s.update({"per_leaf_ms_bf16": s["ms_bf16"], "per_leaf_plain_ms_bf16": s["plain_ms_bf16"],
              "per_leaf_bound_ms_bf16": s["bound_ms_bf16"], "ms_bf16": main["ms"], "plain_ms_bf16": main["plain_ms"],
              "bound_ms_bf16": main["bound_ms"], "bytes_bound_ms_bf16": main["bound_ms"], "ops_bound_ms_bf16": 0.0,
              "max_abs_err_bf16": max(s["max_abs_err_bf16"], main["max_abs_err"]), "library_ms_bf16": None})
    result = {"phase": "kernels", "ok": not failures, "n_shapes": {k: len(v) for k, v in shapes.items()},
              "summary": summary, "groups_bf16": _attention_groups(rows, shapes), "adam8bit_step": step,
              "adam8bit_step_lora": lora_step, "wall_s": dict(wall),
              "failures": failures, "shapes": rows}
    emit({k: v for k, v in result.items() if k != "shapes"})
    check(all(shapes.get(name) for name in TPU_KERNELS), f"a kernel recorded no shape in the probe runs: "
          f"{ {k: len(shapes.get(k, [])) for k in TPU_KERNELS} }")
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return result


# the self-attention shapes of 512px training, one batch element: head dims 40,
# 80 and 160 at the UNet's levels 0-2 ([B, N, M, H, D])
CORRELATED_SHAPES = ((1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80), (1, 256, 256, 8, 160))


def phase_correlated(kernels: dict) -> dict:
    """Both bf16 backward routes, K3 and the split set, at correlated views
    (dO = Q, V = K) whose keys share one component of size 3: dS = P (dP -
    delta) cancels hard there, and a delta from the bf16 O moves dQ by 0.12-0.17
    of its scale (tests/test_torch_port_attention_bf16.py). Each output is
    held to 2e-2 of its own max|plain|. Then K3 against the split set at K3's
    main-path shapes (bf16 sums of phase 2) and the route ``backward_route``
    takes there."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (
        _forward_kernel,
        backward_route,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_bwd_split,
    )

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, failures = [], []
    tol = TOLERANCE["flash_attention_bwd"]["bfloat16"]
    for b, n, m, h, d in CORRELATED_SHAPES:
        q = torch.randn(b, n, h, d, device="cuda", generator=gen).bfloat16()
        shared = 3.0 * torch.randn(b, 1, h, d, device="cuda", generator=gen)
        k = (shared + torch.randn(b, m, h, d, device="cuda", generator=gen)).bfloat16()
        scale = d ** -0.5
        out, lse = _forward_kernel(q, k, k, scale, with_lse=True)
        ref = flash_attention_bwd_plain(q, k, k, q, scale)
        for route, fn in (("fused", flash_attention_bwd), ("split", flash_attention_bwd_split)):
            _, rel, detail = _own_scale_err(fn(q, k, k, out, q, lse, scale), ref)
            row = {"route": route, "shape": [b, n, m, h, d], "rel_err": rel, "tol": tol, **detail}
            rows.append(row)
            if not rel <= tol:
                failures.append(row)
        del q, k, out, lse, ref
    k3 = [r for r in kernels["shapes"] if r["k"] == "flash_attention_bwd" and r["dtype"] == "bfloat16"]
    split = {tuple(r["shape"]): r for r in kernels["shapes"]
             if r["k"] == "flash_attention_bwd_split" and r["dtype"] == "bfloat16"}
    per_shape = [{"shape": r["shape"], "k3_ms": r["ms"], "split_ms": split[tuple(r["shape"])]["ms"],
                  "route": backward_route(r["shape"][2], dtype=torch.bfloat16)} for r in k3]
    res = {"phase": "correlated", "gpu": gpu_line(), "ok": not failures, "cases": rows,
           "k3_ms_at_k3_shapes": sum(r["k3_ms"] for r in per_shape),
           "split_ms_at_k3_shapes": sum(r["split_ms"] for r in per_shape),
           "k3_faster_at": sum(r["k3_ms"] < r["split_ms"] for r in per_shape), "n_k3_shapes": len(per_shape),
           "routes_at_k3_shapes": sorted({r["route"] for r in per_shape}), "per_shape": per_shape}
    emit({k: v for k, v in res.items() if k != "per_shape"})
    check(not failures, f"attention backward departs at correlated views: {failures}")
    return res


def _per_leaf_update(opt, grads, norm) -> None:
    """``AdamW8bit._update`` as it ran before the step was fused: per leaf the
    clip, the one-leaf K9 launch (new code and scale tensors) and the apply,
    each its own launches; the new state kept in local lists."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import adam8bit_update

    _, bc1, bc2, lr = opt._scalars()
    c = torch.tensor(opt.max_grad_norm, dtype=torch.float32, device=norm.device)
    keep = norm < c
    mu, nu = list(opt.mu), list(opt.nu)
    for i, (p, g) in enumerate(zip(opt.params, grads)):
        g = torch.where(keep, g, (g / norm.to(g.dtype)) * c.to(g.dtype))
        upd, mu[i], nu[i] = adam8bit_update(g, mu[i], nu[i], bc1, bc2, opt.b1, opt.b2, opt.eps, opt.block_size)
        t = p * opt.weight_decay
        t.add_(upd)
        t.mul_(-lr)
        p.add_(t)


def phase_optimizer(leaf_shapes, kernels: dict) -> dict:
    """Context for K9: one whole optimizer step over the SD-1.5 UNet's leaves
    (the shapes and layouts of the trainer's parameters, seeded values): the
    f32 foreach ``AdamW._update``, and ``AdamW8bit._update`` with f32 and bf16
    gradients, the per-leaf loop it replaced (``_per_leaf_update``) and the
    fused step (one K9 launch), in turns in this run; CUDA events around each
    (device wall, the host's launches included). Also K9's one-leaf launches
    summed over the leaves of a step (per-shape times of the kernels phase
    times each shape's leaves)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import AdamW, build_lr_schedule, global_norm

    shapes, params, grads, _, _ = sd15_leaves(leaf_shapes, seed=99, state=False)
    sched = build_lr_schedule("constant", 1e-4, 0, 10)
    kw = dict(weight_decay=0.1, max_grad_norm=0.1)
    res = {"phase": "optimizer", "gpu": gpu_line(), "n_leaves": len(shapes),
           "n_params": sum(p.numel() for p in params)}
    opt = AdamW(params, sched, **kw)
    norm = global_norm(grads["float32"])
    res["adamw_f32_foreach_ms"] = cuda_ms(lambda: opt._update(grads["float32"], norm), iters=1)
    res["adamw_f32_state_bytes"] = opt.state_bytes()
    del opt
    opt = AdamW8bit(params, sched, **kw)
    for dname, g in grads.items():
        norm = global_norm(g)
        res[f"adamw8bit_{dname}_grad_per_leaf_ms"] = cuda_ms(lambda: _per_leaf_update(opt, g, norm), iters=1)
        res[f"adamw8bit_{dname}_grad_ms"] = cuda_ms(lambda: opt._update(g, norm), iters=1)
    res["adamw8bit_state_bytes"] = opt.state_bytes()
    rows = [r for r in kernels["shapes"] if r["k"] == "adam8bit_update"]
    for dname in ("float32", "bfloat16"):
        by_shape = {tuple(r["shape"]): r for r in rows if r["dtype"] == dname}
        for field in ("ms", "plain_ms", "bound_ms"):
            res[f"k9_one_leaf_{field}_per_step_{dname}"] = sum(by_shape[sh][field] * n for sh, n in leaf_shapes.items())
    emit(res)
    check(all(torch.isfinite(p).all() for p in params[:: max(1, len(params) // 20)]), "non-finite parameters")
    del opt, params, grads
    free_cuda()
    return res


# --------------------------------------------------------------------------- #
# phases 3-4: the SD-1.5 UNet in f32, card (kernels) vs CPU (plain path)
# --------------------------------------------------------------------------- #


def _sd15_unet_pair(seed: int):
    import copy

    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import cast_for_inference, init_weights
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("cuda"):
        unet = UNetModel(4, 32, presets.sd15_unet_config())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init_weights(unet, gen)
    fill_zero_weights(unet, gen)
    cast_for_inference(unet, torch.float32)
    return unet, copy.deepcopy(unet).cpu()


def phase_unet_parity(seed: int) -> dict:
    """SD-1.5 UNet on a 64x64 latent in float32: CUDA (kernels, TF32 off) vs
    CPU (plain path), within ``full_scale_parity.F32_TOL`` of the output's
    scale, and its bf16 forward's drift from the f32 one on the card
    (recorded): ``scripts/full_scale_parity.py:unet_parity`` at the
    pipeline's 32 groups."""
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.scripts import full_scale_parity

    native.reset_counters()
    t0 = time.perf_counter()
    rec = full_scale_parity.unet_parity(presets.sd15_unet_config(), seed, "cuda", latent=64, groups=32)
    launches = {k: native.COUNTERS[k].count for k in SLICE_KERNELS}
    res = {"phase": "unet_parity", "cpu_reference": True, "latent": [1, 64, 64, 4], **rec, "cuda_launches": launches,
           "seconds": time.perf_counter() - t0, "ok": rec["ok"] and all(launches.values())}
    emit(res)
    check(rec["finite"], "non-finite UNet output on CUDA")
    check(all(launches.values()), f"a kernel was not launched by the CUDA UNet forward: {launches}")
    check(rec["ok"], f"UNet f32 CUDA vs CPU max abs err {rec['max_delta']} > {rec['tol']}")
    return res


# Limits of the f32 gradient parity: both sides f32 with sums in another order
# (cuDNN vs CPU convs, kernels vs plain attention and GroupNorm, K3's atomic
# dq) through ~60 layers forward and back; the forward alone agrees to ~4e-6
# of its scale, so 1e-4 overall leaves room for the backward's longer sums,
# and 1e-3 for the tensor whose gradient is smallest against that error.
GRAD_REL_LIMIT = 1e-4
GRAD_TENSOR_REL_LIMIT = 1e-3
# bf16 compute (autocast over the same f32 weights) vs f32 on the card: the
# JAX package's SD-1.5 UNet drifts 0.0108 (PARITY_FULLSCALE.json, one draw of
# random weights); bf16 keeps 8 mantissa bits and the drift compounds over
# ~60 layers, so the port is held to 2e-2 of the output scale
BF16_DRIFT_LIMIT = 2e-2


def phase_train_parity(seed: int) -> dict:
    """SD-1.5 UNet forward + backward in float32 at a 32x32 latent, batch 1."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    unet, cpu_unet = _sd15_unet_pair(seed)
    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn(1, 32, 32, 4, generator=g)
    t = torch.tensor([301], dtype=torch.int32)
    ctx = torch.randn(1, 77, 768, generator=g)
    w = torch.randn(1, 32, 32, 4, generator=g)
    grads, outs = [], []
    native.reset_counters()
    for module, dev in ((unet, "cuda"), (cpu_unet, "cpu")):
        module.requires_grad_(True)
        t0 = time.perf_counter()
        out = module(x.to(dev), t.to(dev), ctx.to(dev))
        (out * w.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append({n: p.grad.detach().cpu() for n, p in module.named_parameters()})
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: native.COUNTERS[k].count for k in F32_TRAIN_KERNELS}
        else:
            cpu_s = time.perf_counter() - t0
    card, cpu = grads

    # the training step's precision: bf16 autocast over the same f32 weights
    unet.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out_bf = unet(x.cuda(), t.cuda(), ctx.cuda())
    (out_bf.float() * w.cuda()).sum().backward()
    bf_out = out_bf.detach().float().cpu()
    bf_drift = (bf_out - outs[0]).abs().max().item() / max(1.0, outs[0].abs().max().item())
    bf_grad = math.sqrt(sum(((p.grad.detach().cpu() - card[n]).double() ** 2).sum().item()
                            for n, p in unet.named_parameters()) / sum((g.double() ** 2).sum().item()
                                                                       for g in card.values()))
    diff2 = sum(((card[n] - cpu[n]).double() ** 2).sum().item() for n in cpu)
    ref2 = sum((cpu[n].double() ** 2).sum().item() for n in cpu)
    rel = math.sqrt(diff2 / ref2)
    per_tensor = {n: ((card[n] - cpu[n]).norm() / cpu[n].norm().clamp(min=1e-30)).item() for n in cpu}
    worst = max(per_tensor, key=per_tensor.get)
    res = {"phase": "train_parity", "cpu_reference": True, "latent": [1, 32, 32, 4], "n_tensors": len(cpu),
           "grad_rel_err": rel, "limit": GRAD_REL_LIMIT, "worst_tensor": worst,
           "worst_tensor_rel_err": per_tensor[worst], "tensor_limit": GRAD_TENSOR_REL_LIMIT,
           "cuda_launches": launches, "cpu_fwd_bwd_s": cpu_s,
           "all_finite": all(bool(torch.isfinite(v).all()) for v in card.values()),
           "bf16_vs_f32_out_drift": bf_drift, "bf16_drift_limit": BF16_DRIFT_LIMIT,
           "bf16_vs_f32_grad_rel_err": bf_grad, "bf16_finite": bool(torch.isfinite(bf_out).all())}
    res["ok"] = (res["all_finite"] and rel <= GRAD_REL_LIMIT and per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT
                 and all(launches.values()) and res["bf16_finite"] and bf_drift <= BF16_DRIFT_LIMIT)
    emit(res)
    check(res["all_finite"], "non-finite gradient on CUDA")
    check(all(launches.values()), f"a kernel was not launched by the CUDA UNet forward/backward: {launches}")
    check(rel <= GRAD_REL_LIMIT, f"f32 gradient CUDA vs CPU relative error {rel} > {GRAD_REL_LIMIT}")
    check(per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT,
          f"f32 gradient of {worst}: relative error {per_tensor[worst]} > {GRAD_TENSOR_REL_LIMIT}")
    check(res["bf16_finite"] and bf_drift <= BF16_DRIFT_LIMIT,
          f"bf16-autocast UNet output drifts {bf_drift} of scale from f32 (limit {BF16_DRIFT_LIMIT})")
    del unet, cpu_unet, grads
    torch.cuda.empty_cache()
    return res


class _KeepGrads:
    """An optimizer that keeps a CPU copy of the gradients it is handed and applies nothing."""

    def step(self, grads):
        import torch

        self.grads = [g.detach().cpu() for g in grads]
        return False, torch.zeros(())


# the f32 VAE step, card vs CPU: the loss and its parts are f32 sums over the
# image and the latent in another order; 1e-5 relative
VAE_LOSS_REL_LIMIT = 1e-5


def phase_vae_train_parity(seed: int) -> dict:
    """The SD-1.5 VAE's train step in float32 at 64x64, batch 1, the
    posterior noise handed in: loss, its parts and every gradient on the card
    (K1, K3 at the bottleneck's heads of 512 and 128, K6, K7; TF32 off)
    against the same weights on the CPU through the plain path."""
    import copy

    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import build_autoencoder
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_vae_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vae = build_autoencoder(presets.sd15_autoencoder_config(), device="cuda", seed=seed)
    fill_zero_weights(vae, torch.Generator(device="cuda").manual_seed(seed + 1))
    cpu_vae = copy.deepcopy(vae).cpu()
    g = torch.Generator().manual_seed(seed + 3)
    img = torch.rand(1, VAE_PARITY, VAE_PARITY, 3, generator=g) * 2 - 1
    f = vae.downsample_factor
    eps = torch.randn(1, VAE_PARITY // f, VAE_PARITY // f, vae.latent_channels, generator=g)
    metrics, grads = [], []
    for module, dev in ((vae, "cuda"), (cpu_vae, "cpu")):
        train_step, _ = make_vae_train_step(module, kl_weight=1.0)
        state = TrainState(module, _KeepGrads())
        native.reset_counters()
        t0 = time.perf_counter()
        m = train_step(state, {"pixel_values": img.to(dev)}, eps.to(dev))
        metrics.append({k: float(v) for k, v in m.items() if k != "grad_norm"})
        grads.append(dict(zip(state.names, state.optimizer.grads)))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: native.COUNTERS[k].count for k in VAE_F32_KERNELS}
            bwd_shapes = sorted(k[:-1] for k in native.COUNTERS["flash_attention_bwd"].shapes)
        else:
            cpu_s = time.perf_counter() - t0
    card, cpu = grads
    loss_rel = {k: abs(metrics[0][k] - metrics[1][k]) / max(abs(metrics[1][k]), 1e-30) for k in metrics[1]}
    rel = math.sqrt(sum(((card[n] - cpu[n]).double() ** 2).sum().item() for n in cpu)
                    / sum((cpu[n].double() ** 2).sum().item() for n in cpu))
    per_tensor = {n: ((card[n] - cpu[n]).norm() / cpu[n].norm().clamp(min=1e-30)).item() for n in cpu}
    worst = max(per_tensor, key=per_tensor.get)
    res = {"phase": "vae_train_parity", "cpu_reference": True, "image": [1, VAE_PARITY, VAE_PARITY, 3],
           "n_tensors": len(cpu), "card": metrics[0], "cpu": metrics[1], "loss_rel_err": loss_rel,
           "loss_limit": VAE_LOSS_REL_LIMIT, "grad_rel_err": rel, "limit": GRAD_REL_LIMIT, "worst_tensor": worst,
           "worst_tensor_rel_err": per_tensor[worst], "tensor_limit": GRAD_TENSOR_REL_LIMIT,
           "cuda_launches": launches, "k3_shapes": bwd_shapes, "cpu_step_s": cpu_s,
           "all_finite": all(bool(torch.isfinite(v).all()) for v in card.values())
           and all(math.isfinite(v) for v in metrics[0].values())}
    res["ok"] = (res["all_finite"] and max(loss_rel.values()) <= VAE_LOSS_REL_LIMIT and rel <= GRAD_REL_LIMIT
                 and per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT and all(launches.values())
                 and [1, 64, 64, 1, 512] in [list(k) for k in bwd_shapes])
    emit(res)
    check(res["all_finite"], "non-finite VAE loss or gradient on CUDA")
    check(all(launches.values()), f"a kernel was not launched by the f32 VAE step on CUDA: {launches}")
    check([1, 64, 64, 1, 512] in [list(k) for k in bwd_shapes], f"K3 never ran at head dim 512: {bwd_shapes}")
    check(max(loss_rel.values()) <= VAE_LOSS_REL_LIMIT,
          f"f32 VAE loss CUDA vs CPU relative error {loss_rel} > {VAE_LOSS_REL_LIMIT}")
    check(rel <= GRAD_REL_LIMIT, f"f32 VAE gradient CUDA vs CPU relative error {rel} > {GRAD_REL_LIMIT}")
    check(per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT,
          f"f32 VAE gradient of {worst}: relative error {per_tensor[worst]} > {GRAD_TENSOR_REL_LIMIT}")
    del vae, cpu_vae, grads
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phase 5: the txt2img slice; phases 6-7: training and the checkpoint round trip
# --------------------------------------------------------------------------- #


def phase_slice(model, steps: int, num_images: int) -> dict:
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native

    decoded = []
    hook = model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach()))
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    prompt = "a photograph of an astronaut riding a horse"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_counters()
        t0 = time.perf_counter()
        with torch.inference_mode():
            images = pipeline.sample(model, image_size=512, prompt=prompt, time_steps=steps,
                                     guidance_scale=7.5, save_dir=out_dir, num_images=num_images, seed=42)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        hook.remove()

    # the denoising loop alone, for seconds per step (not part of the count)
    with torch.inference_mode():
        ctx = model.encode_prompts([prompt] * num_images)
        noise = torch.randn(model.latent_shape(num_images, 512), device="cuda", dtype=model.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps, sampler="ddim")
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0

    img = decoded[0]
    res = {
        "phase": "slice", "gpu": gpu_line(), "image_size": 512, "num_images": num_images,
        "steps": steps, "guidance_scale": 7.5, "dtype": str(model.dtype),
        "decoded_shape": list(img.shape), "finite": bool(torch.isfinite(img).all()),
        "png_files": sorted(os.listdir(out_dir)), "launches": launches,
        "total_s": total_s, "images_per_s": num_images / total_s, "s_per_step": loop_s / steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    res["ok"] = (res["finite"] and res["decoded_shape"] == [num_images, 512, 512, 3]
                 and all(launches[k] > 0 for k in SLICE_KERNELS)
                 and len(images) == num_images and images[0].shape == (512, 512, 3))
    emit(res)
    check(res["decoded_shape"] == [num_images, 512, 512, 3], f"decoded shape {res['decoded_shape']}")
    check(res["finite"], "non-finite values in the decoded image")
    check(all(launches[k] > 0 for k in SLICE_KERNELS), f"a kernel was not launched by the slice: {launches}")
    check(res["ok"], "slice output check failed")
    return res


def _timed(fn):
    """(fn(), host seconds) around work that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_hires(model, steps: int) -> dict:
    """(a) txt2img at 1024x1024 with the whole decode; (b) the hires fix from
    512x512 with the tiled decode; then (b)'s stages timed one by one."""
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native

    decoded = []
    hook = model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach()))
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    prompt = "a photograph of an astronaut riding a horse"
    fix = {"hires_scale": 2.0, "hires_strength": 0.6, "vae_tile": HIRES_TILE}
    runs = {}
    try:
        for run, size, extra in (("txt2img_1024", HIRES, {}), ("hires_fix", HIRES_BASE, fix)):
            decoded.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            native.reset_counters()
            with torch.inference_mode():
                images, total_s = _timed(lambda: pipeline.sample(
                    model, image_size=size, prompt=prompt, time_steps=steps, guidance_scale=7.5, save_dir=out_dir,
                    num_images=1, seed=42, name=run, **extra))
            runs[run] = {
                "image_size": size, **extra, "launches": launch_counts(),
                "flash_kv_lengths": sorted({key[2] for key in native.COUNTERS["flash_attention"].shapes}),
                "decoder_outputs": [list(o.shape) for o in decoded],
                "finite": all(bool(torch.isfinite(o).all()) for o in decoded),
                "image_shape": list(images[0].shape), "total_s": total_s, "images_per_s": 1.0 / total_s,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            }
    finally:
        hook.remove()

    # the stages alone (not part of the counts): the 1024 loop; the hires fix's
    # base loop, refine, and tiled vs whole decode of the refined latent
    with torch.inference_mode():
        ctx = model.encode_prompts([prompt])
        gen = torch.Generator(device="cuda").manual_seed(7)
        noise = torch.randn(model.latent_shape(1, HIRES), device="cuda", generator=gen).to(model.dtype)
        _, loop_s = _timed(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps, sampler="ddim"))
        noise = torch.randn(model.latent_shape(1, HIRES_BASE), device="cuda", generator=gen).to(model.dtype)
        x0, base_s = _timed(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps, sampler="ddim"))
        x1, refine_s = _timed(lambda: pipeline.hires_refine(
            model, x0, ctx, guidance_scale=7.5, sampler="ddim", time_steps=steps, hires_scale=2.0,
            hires_strength=0.6, generator=torch.Generator().manual_seed(8)))
        tiled, tiled_s = _timed(lambda: model.decode_latent(x1, tile=HIRES_TILE))
        whole, whole_s = _timed(lambda: model.decode_latent(x1))
        tile_diff = (tiled.float() - whole.float()).abs().max().item()
        noise = torch.randn(model.latent_shape(1, HIRES), device="cuda", generator=gen).to(model.dtype)
        profile = profile_device(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=2, sampler="ddim"),
                                 2, "step")
    refine_steps = max(min(round(steps * 0.6), steps), 1)
    a, b = runs["txt2img_1024"], runs["hires_fix"]
    res = {
        "phase": "hires", "gpu": gpu_line(), "steps": steps, "guidance_scale": 7.5, "dtype": str(model.dtype),
        "runs": runs, "s_per_step_1024": loop_s / steps,
        "hires_fix_stages_s": {"base": base_s, "refine": refine_s, "tiled_decode": tiled_s,
                               "whole_decode": whole_s},
        "refine_steps": refine_steps, "refine_s_per_step": refine_s / refine_steps,
        "tiled_vs_whole_decode_max_abs": tile_diff, "tiled_vs_whole_image_max_abs": whole.float().abs().max().item(),
        "profile_1024_step": profile,
    }
    emit({k: v for k, v in res.items() if k != "profile_1024_step"})
    emit({"phase": "hires_profile", **{k: v for k, v in profile.items() if k != "top_kernels"}})
    full = [1, HIRES, HIRES, 3]
    check(a["decoder_outputs"] == [full] and a["finite"] and a["image_shape"] == full[1:],
          f"1024x1024 txt2img: decoder outputs {a['decoder_outputs']}, finite {a['finite']}")
    check(HIRES * HIRES // 64 in a["flash_kv_lengths"], f"K1 never ran at kv 16384: {a['flash_kv_lengths']}")
    check(len(b["decoder_outputs"]) > 1 and b["finite"] and b["image_shape"] == full[1:],
          f"hires fix: decoder tiles {b['decoder_outputs']}, finite {b['finite']}, image {b['image_shape']}")
    for run in runs.values():
        check(all(run["launches"][k] > 0 for k in SLICE_KERNELS), f"a kernel was not launched: {run['launches']}")
    check(bool(torch.isfinite(tiled).all() and torch.isfinite(whole).all()), "non-finite staged decode")
    return res


def phase_samplers(model, steps: int) -> dict:
    """``pipeline.sample`` once per run of ``SAMPLER_RUNS`` at 512x512, batch
    1, CFG 7.5: each decodes to a finite [1, 512, 512, 3] and launches K1, K6
    and K8 (counts set to 0 before each run, read after it); the UNet runs
    once a step (heun: twice, but once on its last step). Then each loop alone
    (not counted), for seconds per step."""
    import dataclasses

    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion
    from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
    from stable_diffusion_pytorch_tpu_torch.ops import native

    zt = LatentDiffusion(model.unet, model.autoencoder, model.text_encoder,
                         make_schedule(dataclasses.replace(presets.sd15_ddpm_config(), zero_terminal_snr=True)),
                         compat=model.compat, compute_dtype=model.dtype)
    decoded, calls = [], [0]
    hooks = [model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach())),
             model.unet.register_forward_pre_hook(lambda m, i: calls.__setitem__(0, calls[0] + 1))]
    prompt = "a photograph of an astronaut riding a horse"
    runs = {}
    try:
        with torch.inference_mode():
            ctx = model.encode_prompts([prompt])
            for name, kw in SAMPLER_RUNS:
                m = zt if name.endswith("_zt") else model
                decoded.clear()
                calls[0] = 0
                native.reset_counters()
                images, total_s = _timed(lambda: pipeline.sample(
                    m, image_size=512, prompt=prompt, time_steps=steps, guidance_scale=7.5, save_dir=None,
                    seed=42, **kw))
                launches, unet_calls = launch_counts(), calls[0]
                noise = torch.randn(m.latent_shape(1, 512), device="cuda", dtype=m.dtype,
                                    generator=torch.Generator(device="cuda").manual_seed(7))
                _, loop_s = _timed(lambda: m.sample(noise, ctx, guidance_scale=7.5, time_steps=steps,
                                                    generator=torch.Generator().manual_seed(8), **kw))
                runs[name] = {
                    **kw, "launches": launches, "unet_calls": unet_calls,
                    "decoded_shape": list(decoded[0].shape), "finite": bool(torch.isfinite(decoded[0]).all()),
                    "image_shape": list(images[0].shape), "total_s": total_s, "s_per_step": loop_s / steps,
                }
    finally:
        for h in hooks:
            h.remove()
    res = {"phase": "samplers", "gpu": gpu_line(), "steps": steps, "guidance_scale": 7.5, "image_size": 512,
           "dtype": str(model.dtype), "runs": runs}
    emit(res)
    for name, run in runs.items():
        want_calls = 2 * steps - 1 if run["sampler"] == "heun" else steps
        check(run["decoded_shape"] == [1, 512, 512, 3] and run["finite"] and run["image_shape"] == [512, 512, 3],
              f"sampler run {name}: decoded {run['decoded_shape']}, finite {run['finite']}")
        check(all(run["launches"][k] > 0 for k in SLICE_KERNELS), f"sampler run {name}: a kernel was not launched: "
              f"{run['launches']}")
        check(run["unet_calls"] == want_calls, f"sampler run {name}: {run['unet_calls']} UNet calls, want {want_calls}")
    return res


# --------------------------------------------------------------------------- #
# phase 6d: the sampling-side features
# --------------------------------------------------------------------------- #


def weighted_long_prompt(model) -> str:
    """An emphasis prompt whose body needs two 75-token windows (by the
    model's tokenizer): its context is [1, 154, 768]."""
    words = "a (photograph:1.3) of an astronaut riding a ((white)) horse on the [moon]".split()
    prompt, i = "", 0
    while len(model.text_encoder._weighted_body(prompt)[0]) <= 90:
        prompt, i = f"{prompt} {words[i % len(words)]}".strip(), i + 1
    return prompt


def smoke_image(seed: int, size: int = 512):
    """A seeded smooth uint8 RGB image: the init image and the control hint."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([np.sin(6.28 * (a * xx + b * yy) + c) for a, b, c in rng.uniform(0.5, 3.0, (3, 3))], -1)
    return ((img + 1.0) * 127.5).astype(np.uint8)


def feature_plans(unet_cfg) -> dict:
    """Launches worked out from the block plans: K1 (flash_attention), K6
    (group_norm) and K8 (group_norm_cat) of one full UNet call, of one
    DeepCache call on the cached trunk (the level-0 blocks and the out
    head), and of one ControlNet call (the encoder copy)."""
    from stable_diffusion_pytorch_tpu_torch.models.unet import plan_input_blocks, plan_output_blocks

    ch = list(unet_cfg.channels_list)
    in_plan, skips, mid_ch, _, attn_mult = plan_input_blocks(ch[0], ch, unet_cfg.num_res_blocks,
                                                             unet_cfg.attention_resolutions)
    out_plan, _ = plan_output_blocks(ch, unet_cfg.num_res_blocks, unet_cfg.attention_resolutions, skips, mid_ch,
                                     attn_mult)
    attn = 2 * unet_cfg.n_layers  # self and cross attention per transformer block

    def count(ins, outs, mid: bool, head: bool):
        k = {"flash_attention": 0, "group_norm": 0, "group_norm_cat": 0}
        for block in ins:  # ("res", in, out, attn) or ("down", ch)
            if block[0] == "res":
                k["group_norm"] += 2 + bool(block[3])
                k["flash_attention"] += attn * bool(block[3])
        for block in outs:  # ("res", in + skip, out, attn, upsample): the first norm is K8
            k["group_norm_cat"] += 1
            k["group_norm"] += 1 + bool(block[3])
            k["flash_attention"] += attn * bool(block[3])
        if mid:  # ResBlock, transformer, ResBlock
            k["group_norm"] += 5
            k["flash_attention"] += attn
        k["group_norm"] += bool(head)
        return k

    n0, n_shallow = unet_cfg.num_res_blocks, unet_cfg.num_res_blocks + 1
    return {"unet_call": count(in_plan, out_plan, True, True),
            "deep_cache_call": count(in_plan[:n0], out_plan[-n_shallow:], False, True),
            "controlnet_call": count(in_plan, [], True, False)}


def _feature_run(model, name: str, fn, nets=()) -> dict:
    """One feature run: counts set to 0 before ``fn()``, read after it; CUDA
    events at each UNet (and ControlNet) call and at the VAE decode give
    s/step (first model call to the decode, over the UNet calls) and each
    UNet call's launches (K1, K6, K8, from one call's start to the next)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    kernels = ("flash_attention", "group_norm", "group_norm_cat")
    marks, decoded, latents = [], [], []

    def mark(kind):
        def hook(module, args, kwargs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((kind, ev, {k: native.COUNTERS[k].count for k in kernels}))
        return hook

    hooks = [model.unet.register_forward_pre_hook(mark("unet")),
             model.autoencoder.post_quant_conv.register_forward_pre_hook(
                 lambda m, a: latents.append(a[0].detach())),
             model.autoencoder.decoder.register_forward_pre_hook(mark("decode")),
             model.autoencoder.decoder.register_forward_hook(lambda m, a, o: decoded.append(o.detach()))]
    hooks += [net.register_forward_pre_hook(mark("controlnet")) for net in nets]
    try:
        torch.cuda.synchronize()
        native.reset_counters()
        with torch.inference_mode():
            out, total_s = _timed(fn)
        launches = launch_counts()
        kv = sorted({key[2] for key in native.COUNTERS["flash_attention"].shapes})
    finally:
        for h in hooks:
            h.remove()
    unet_marks = [i for i, m in enumerate(marks) if m[0] == "unet"]
    end = next(i for i, m in enumerate(marks) if m[0] == "decode")
    per_call = []
    for j, i in enumerate(unet_marks):
        nxt = unet_marks[j + 1] if j + 1 < len(unet_marks) else end
        # a ControlNet call before the next UNet call belongs to the next step
        nxt = next((k for k in range(i + 1, nxt) if marks[k][0] == "controlnet"), nxt)
        per_call.append({k: marks[nxt][2][k] - marks[i][2][k] for k in kernels})
    loop_ms = marks[0][1].elapsed_time(marks[end][1])
    img = decoded[-1]
    return {"run": name, "launches": launches, "unet_calls": len(unet_marks), "per_unet_call": per_call,
            "flash_kv_lengths": kv, "decoded_shape": list(img.shape), "finite": bool(torch.isfinite(img).all()),
            "total_s": total_s, "s_per_step": loop_ms / 1e3 / len(unet_marks), "_image": img.float(),
            "_latent": latents[-1], "_out": out}


def phase_features(model, steps: int, work: str) -> dict:
    """The sampling-side features at SD-1.5 width, 512x512, bf16, CFG 7.5,
    ``steps`` DDIM steps, each through the entry point a user calls and each
    decoded to a finite [1, 512, 512, 3]: a plain run (the baseline of the
    counts); a weighted 2-chunk prompt (context [1, 154, 768], K1 at kv 154);
    img2img at strength 0.75; inpaint with a half mask (the kept half of the
    last latent is the encoded init, bit for bit); DeepCache at interval 3
    (a cached step launches the level-0 blocks' K1, worked out from the
    plan); ControlNet with one net and with two, zero convs filled (K1 and
    K6 per step above the plain run's by the encoder's count from
    ``plan_input_blocks``, times the nets; another image); txt2img on a model
    built with a rank-8 LoRA merged into its f32 weights (another image);
    and a textual-inversion prompt loaded from a checkpoint in the port's
    layout (its sentinel ids in the prompt)."""
    import json as _json

    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import build_controlnet
    from stable_diffusion_pytorch_tpu_torch.models.lora import init_lora
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    prompt = "a photograph of an astronaut riding a horse"
    kw = dict(image_size=512, time_steps=steps, guidance_scale=7.5, save_dir=None, seed=42)
    plans = feature_plans(presets.sd15_unet_config())
    init, hint = smoke_image(1), smoke_image(2)
    mask = np.zeros((512, 512), np.uint8)
    mask[:, :256] = 255  # repaint the left half
    runs = {}

    def run(name, fn, nets=()):
        runs[name] = _feature_run(model, name, fn, nets)
        return runs[name]

    run("plain", lambda: pipeline.sample(model, prompt=prompt, **kw))
    long_prompt = weighted_long_prompt(model)
    with torch.inference_mode():
        ctx_shape = list(model.encode_prompts([long_prompt]).shape)
    run("weighted_long", lambda: pipeline.sample(model, prompt=long_prompt, **kw))
    run("img2img", lambda: pipeline.img2img(model, init, prompt=prompt, strength=0.75, image_size=512,
                                            time_steps=steps, guidance_scale=7.5, save_dir=None, seed=42))
    inits = []
    real_init = pipeline._init_latents
    pipeline._init_latents = lambda *a: inits.append(real_init(*a)) or inits[-1]
    try:
        run("inpaint", lambda: pipeline.inpaint(model, init, mask, prompt=prompt, image_size=512, time_steps=steps,
                                                guidance_scale=7.5, save_dir=None, seed=42))
    finally:
        pipeline._init_latents = real_init
    run("deep_cache", lambda: pipeline.sample(model, prompt=prompt, deep_cache_interval=DEEP_CACHE_INTERVAL, **kw))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    nets = [build_controlnet(presets.sd15_unet_config(), presets.sd15_autoencoder_config(), dtype=model.dtype,
                             device="cuda", seed=SEED + 3 + i) for i in range(2)]
    for net in nets:
        fill_zero_weights(net, gen)
    for n in (1, 2):
        model.attach_controlnet(nets[:n])
        hints = hint if n == 1 else [hint, smoke_image(3)]
        run(f"controlnet_{n}", lambda: pipeline.sample(model, prompt=prompt, control_image=hints, control_scale=0.8,
                                                       **kw), nets[:n])
    model.controlnet = None
    del nets
    # textual inversion from a checkpoint in the port's layout
    ti_dir = os.path.join(work, "ti")
    vectors = torch.randn(2, 768, generator=torch.Generator().manual_seed(SEED + 5)) * 0.02
    save_checkpoint(os.path.join(ti_dir, "checkpoint-1"), {"step": 1, "params": {"ti": vectors}, "ema_params": None})
    with open(os.path.join(ti_dir, "textual_inversion.json"), "w") as f:
        _json.dump({"placeholder_token": "<smoke-token>", "num_vectors": 2}, f)
    token = model.text_encoder.load_textual_inversion(ti_dir)
    ti_prompt = f"a photograph of {token} riding a horse"
    ti_ids = model.text_encoder.tokenize([ti_prompt]).input_ids
    run("textual_inversion", lambda: pipeline.sample(model, prompt=ti_prompt, **kw))
    model.text_encoder._ti = None
    # txt2img on the same seeded model with a rank-8 LoRA merged before the cast
    shapes = {n: t for n, t in model.unet.state_dict().items()}
    lora = {k: torch.randn(v.shape, device="cuda", generator=gen) * 0.02
            for k, v in init_lora(shapes, LORA_RANK, "attn", gen).items()}
    del shapes
    lora_model = build_sd15("cuda", model.dtype, SEED, lora=(lora, 1.0))
    runs["lora"] = _feature_run(lora_model, "lora", lambda: pipeline.sample(lora_model, prompt=prompt, **kw))
    del lora_model, lora
    free_cuda()

    plain = runs["plain"]
    per_step = lambda r, k: (r["launches"][k] - plain["launches"][k]) / steps  # noqa: E731
    m = mask[None, :, :, None] == 0
    keep = torch.from_numpy(np.ascontiguousarray(m[:, ::8, ::8])).cuda().expand_as(inits[0])
    refresh = [i % DEEP_CACHE_INTERVAL == 0 for i in range(steps)]
    dc_calls = runs["deep_cache"]["per_unet_call"]
    checks = {
        "weighted_long_context": ctx_shape == [1, 154, 768] and 154 in runs["weighted_long"]["flash_kv_lengths"],
        "inpaint_kept_half_is_the_init": bool(torch.equal(runs["inpaint"]["_latent"][keep], inits[0][keep])),
        "deep_cache_cached_step_k1": all(c["flash_attention"] == plans["deep_cache_call" if not r else "unet_call"]
                                         ["flash_attention"] for c, r in zip(dc_calls, refresh)),
        "textual_inversion_ids": int((np.asarray(ti_ids) >= 49408).sum()) == 2,
    }
    for n in (1, 2):
        r = runs[f"controlnet_{n}"]
        checks[f"controlnet_{n}_k1_per_step"] = per_step(r, "flash_attention") == n * plans["controlnet_call"][
            "flash_attention"]
        checks[f"controlnet_{n}_k6_per_step"] = per_step(r, "group_norm") == n * plans["controlnet_call"]["group_norm"]
    diff = {name: (runs[name]["_image"] - plain["_image"]).abs().max().item()
            for name in ("controlnet_1", "controlnet_2", "lora", "deep_cache", "textual_inversion")}
    checks["controlnet_changes_the_image"] = diff["controlnet_1"] > 0 and diff["controlnet_2"] > 0
    checks["lora_changes_the_image"] = diff["lora"] > 0
    records = {name: {k: v for k, v in r.items() if not k.startswith("_")} for name, r in runs.items()}
    for name in ("controlnet_1", "controlnet_2"):
        n = int(name[-1])
        records[name]["per_step_above_plain"] = {k: per_step(runs[name], k) for k in
                                                 ("flash_attention", "group_norm", "group_norm_cat")}
        records[name]["per_step_plan"] = {k: n * v for k, v in plans["controlnet_call"].items()}
    records["deep_cache"]["interval"] = DEEP_CACHE_INTERVAL
    records["deep_cache"]["cached_step_plan"] = plans["deep_cache_call"]
    records["weighted_long"]["context_shape"] = ctx_shape
    res = {"phase": "features", "gpu": gpu_line(), "steps": steps, "guidance_scale": 7.5, "image_size": 512,
           "dtype": str(model.dtype), "plans": plans, "checks": checks, "max_abs_vs_plain": diff, "runs": records}
    emit(res)
    for name, r in runs.items():
        check(r["decoded_shape"] == [1, 512, 512, 3] and r["finite"],
              f"feature run {name}: decoded {r['decoded_shape']}, finite {r['finite']}")
        check(all(r["launches"][k] > 0 for k in SLICE_KERNELS), f"feature run {name}: a kernel was not launched: "
              f"{r['launches']}")
    check(all(checks.values()), f"feature checks failed: {checks}")
    return res


def _png_pixels(data: bytes):
    """HWC uint8 pixels of a PNG with filter-0 rows (what the port's
    ``encode_png`` writes)."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"not a PNG: {data[:40]!r}")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, _, color = header[:4]
    channels = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    check(not rows[:, 0].any(), "PNG rows use a filter")
    return rows[:, 1:].reshape(h, w, channels)


def _bucket_vs_solo(model, steps: int) -> dict:
    """How far a row of a server bucket (4 requests, per-row seeds, UNet
    batch 8 with CFG) lies from the same request rendered alone (UNet batch
    2), as a share of the solo output's max|.|: (a) the UNet call at the
    loop's first timestep, its uncond and cond rows (the quantity the bf16
    drift bar of 2e-2 holds), and their CFG combination at 7.5, which scales
    a difference of the two rows by 7.5; (b) the decoded image after
    ``steps`` DDIM steps; and, beside them, (c) the decoded gap of the solo
    render when its x_T is scaled by 1 + 2^-7 (one or two bf16 ulps): the
    loop's own sensitivity to a rounding-sized change, which (b) inherits
    from (a)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import cfg_combine

    n, dtype = len(SERVE_SEEDS), model.dtype
    decoded = []
    hook = model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach().float()))
    try:
        with torch.inference_mode():
            x = torch.cat([torch.randn(model.latent_shape(1, 512), generator=torch.Generator().manual_seed(s))
                           for s in SERVE_SEEDS]).to("cuda", dtype)
            ctx = model.encode_prompts([SERVE_PROMPT]).to(dtype)
            unc = model.encode_uncond(1, "").to(dtype)
            t0 = 1000 - 1000 // steps

            def unet(rows):  # the CFG-doubled call [uncond, cond], as the loop makes it
                b = rows.shape[0]
                return model.unet(torch.cat([rows, rows]), torch.full((2 * b,), t0, dtype=torch.int32, device="cuda"),
                                  torch.cat([unc.expand(b, -1, -1), ctx.expand(b, -1, -1)])).float()

            bucket_out = unet(x)
            solo_out = [unet(x[i:i + 1]) for i in range(n)]
            kw = dict(image_size=512, time_steps=steps, guidance_scale=7.5, save_dir=None, sampler="ddim")
            pipeline.sample(model, prompt=[SERVE_PROMPT] * n, seed=list(SERVE_SEEDS), **kw)
            bucket = decoded.pop()
            solo = []
            for s in SERVE_SEEDS:
                pipeline.sample(model, prompt=[SERVE_PROMPT], seed=[s], **kw)
                solo.append(decoded.pop()[0])
            nudged = (x[:1].float() * (1 + 2 ** -7)).to(dtype)
            for x_T in (x[:1], nudged):
                model.decode_latent(model.sample(x_T, ctx, guidance_scale=7.5, time_steps=steps, sampler="ddim"))
            nudge_gap = (decoded[1] - decoded[0]).abs().max().item()
    finally:
        hook.remove()
    out_scale = max(o.abs().max().item() for o in solo_out)
    out_gap = max(max((bucket_out[i] - solo_out[i][0]).abs().max().item(),
                      (bucket_out[n + i] - solo_out[i][1]).abs().max().item()) for i in range(n))
    cfg = [cfg_combine(o[:1], o[1:], 7.5) for o in solo_out]
    cfg_gap = max((cfg_combine(bucket_out[i], bucket_out[n + i], 7.5) - cfg[i][0]).abs().max().item()
                  for i in range(n))
    cfg_scale = max(c.abs().max().item() for c in cfg)
    scale = max(img.abs().max().item() for img in solo)
    gap = max((bucket[i] - solo[i]).abs().max().item() for i in range(n))
    return {"dtype": str(dtype), "unet_call_timestep": t0, "unet_call_max_abs": out_gap, "unet_call_scale": out_scale,
            "unet_call_share": out_gap / out_scale, "cfg_combined_share": cfg_gap / cfg_scale,
            "decoded_max_abs": gap, "decoded_scale": scale,
            "decoded_share": gap / scale, "nudged_x_T_decoded_share": nudge_gap / scale}


def phase_serve(work: str, steps: int) -> dict:
    """The port's server (``scripts/serve.py``: ``build_service`` at SD-1.5
    width, 512x512 default, ``--max-batch 4``, seed 0 with the zero layers
    filled as ``build_sd15`` fills them) behind a ``ThreadingHTTPServer`` on
    127.0.0.1, in process. First, not counted, ``_bucket_vs_solo`` on a
    float32 build of the same weights and on the server's bf16 model: a
    bucket row's UNet call must lie within 2e-2 of scale of its solo call
    in bf16 (the bf16 drift bar), and its float32 image within 2e-2 of its
    solo render; the bf16 images' gap is recorded beside the loop's own
    sensitivity (10 DDIM steps with CFG 7.5 on random weights carry a
    rounding-sized change in x_T to ~0.7 of the image's scale). Then, counts set to 0: /healthz; four solo
    requests, the same four at once from four threads (fewer than 4 batches;
    the gap of the PNGs in uint8 levels); one request per sampler; the async
    route (submit, /progress, /result); /reload of a perturbed UNet in the
    trainer's checkpoint format (another image, the same bytes on a repeat;
    a missing path is a 400 and serving goes on). Any other status fails the
    phase."""
    import shutil
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.scripts import serve
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint

    shutil.rmtree(work, ignore_errors=True)
    f32 = build_sd15("cuda", torch.float32, SEED)
    gap_f32 = _bucket_vs_solo(f32, steps)
    del f32
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    service, cfg = serve.build_service([
        *SD15_FLAGS, "--device", "cuda", "--seed", str(SEED), "--mixed-precision", "bf16",
        "--max-batch", str(SERVE_MAX_BATCH), "--default-image-size", "512", "--default-steps", str(steps),
        "--batch-window-ms", str(SERVE_WINDOW_MS)])
    model = service.model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for m in (model.unet, model.autoencoder):
        fill_zero_weights(m, gen)

    # the bucket-vs-solo gaps on the model alone, before the server takes requests
    gap_bf16 = _bucket_vs_solo(model, steps)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    statuses = []

    def call(path, payload=None, want=200):
        req = urllib.request.Request(base + path, data=None if payload is None else json.dumps(payload).encode(),
                                     method="GET" if payload is None else "POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        statuses.append((path, status, want))
        check(status == want, f"{path} {payload}: status {status}, want {want}: {body[:300]!r}")
        return body, time.perf_counter() - t0

    def health():
        return json.loads(call("/healthz")[0])

    try:
        torch.cuda.synchronize()
        native.reset_counters()
        t_phase = time.perf_counter()
        samplers = health()["samplers"]
        check(samplers == ["ddim", "ddpm", "dpmpp", "euler", "euler_a", "heun", "dpmpp_sde"],
              f"/healthz samplers {samplers}")
        solo_png, solo_s = {}, []
        for s in SERVE_SEEDS:
            solo_png[s], dt = call("/txt2img", {"prompt": SERVE_PROMPT, "seed": s})
            solo_s.append(dt)
        before = health()
        burst, errors = {}, []

        def worker(s):
            try:
                burst[s] = call("/txt2img", {"prompt": SERVE_PROMPT, "seed": s})[0]
            except Exception as exc:  # noqa: BLE001 — collected, and the phase fails on it below
                errors.append(f"seed {s}: {exc}")

        threads = [threading.Thread(target=worker, args=(s,)) for s in SERVE_SEEDS]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        check(not errors and len(burst) == len(SERVE_SEEDS), f"burst requests failed: {errors}")
        after = health()
        burst_batches = after["batches_run"] - before["batches_run"]
        gaps = {s: int(np.abs(_png_pixels(burst[s]).astype(np.int16) - _png_pixels(solo_png[s])).max())
                for s in SERVE_SEEDS}
        per_sampler = {}
        for sampler in samplers:
            body, dt = call("/txt2img", {"prompt": SERVE_PROMPT, "seed": 21, "sampler": sampler})
            per_sampler[sampler] = {"s": dt, "shape": list(_png_pixels(body).shape)}
        rid = json.loads(call("/txt2img_async", {"prompt": SERVE_PROMPT, "seed": 31}, want=202)[0])["request_id"]
        states, deadline = [], time.time() + 600
        while time.time() < deadline:
            info = json.loads(call(f"/progress/{rid}")[0])
            states.append(info["state"])
            check(info["state"] in ("queued", "running", "done"), f"/progress: {info}")
            if info["state"] == "done":
                break
            time.sleep(0.02)
        check(states[-1] == "done", f"async request not done: {states[-10:]}")
        async_shape = list(_png_pixels(call(f"/result/{rid}")[0]).shape)
        # /reload: a perturbed UNet saved as the trainer saves it
        req = {"prompt": SERVE_PROMPT, "seed": 41}
        before_png = call("/txt2img", req)[0]
        g = torch.Generator().manual_seed(5)
        params = {}
        for n, p in model.unet.named_parameters():
            cpu = p.detach().float().cpu()
            params[n] = (cpu + 0.02 * cpu.std().nan_to_num() * torch.randn(cpu.shape, generator=g)).to(p.dtype)
        ckpt = os.path.join(work, "ckpt", "checkpoint-1")
        save_checkpoint(ckpt, {"step": 1, "params": params, "opt_state": {}, "ema_params": None, "epoch": None})
        del params
        reload_info = json.loads(call("/reload", {"unet_checkpoint": os.path.join(work, "ckpt")})[0])
        after_png = call("/txt2img", req)[0]
        repeat_png = call("/txt2img", req)[0]
        call("/reload", {"unet_checkpoint": os.path.join(work, "missing")}, want=400)
        still_png = call("/txt2img", req)[0]
        final = health()
        phase_s = time.perf_counter() - t_phase
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        thread.join(timeout=60)
    byte_identical = all(burst[s] == solo_png[s] for s in SERVE_SEEDS)
    res = {
        "phase": "serve", "gpu": gpu_line(), "image_size": 512, "steps": steps, "guidance_scale": 7.5,
        "max_batch": SERVE_MAX_BATCH, "batch_window_ms": SERVE_WINDOW_MS, "dtype": str(model.dtype),
        "solo_s": solo_s, "solo_p50_s": statistics.median(solo_s),
        "burst_requests": len(SERVE_SEEDS), "burst_s": burst_s, "burst_requests_per_s": len(SERVE_SEEDS) / burst_s,
        "burst_batches": burst_batches, "batched_vs_solo_byte_identical": byte_identical,
        "batched_vs_solo_max_uint8_levels": max(gaps.values()), "batched_vs_solo_uint8_levels": gaps,
        "bucket_vs_solo_bf16": gap_bf16, "bucket_vs_solo_f32": gap_f32,
        "per_sampler": per_sampler, "async_states": sorted(set(states)), "async_image_shape": async_shape,
        "reload": reload_info, "reload_changed_image": after_png != before_png,
        "reload_repeat_identical": repeat_png == after_png, "serving_after_bad_reload": still_png == after_png,
        "requests_served": final["requests_served"], "batches_run": final["batches_run"], "reloads": final["reloads"],
        "requests": len(statuses), "phase_s": phase_s, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    del service, model
    emit(res)
    check(burst_batches < len(SERVE_SEEDS), f"the burst ran {burst_batches} batches for {len(SERVE_SEEDS)} requests")
    check(byte_identical or gap_bf16["unet_call_share"] <= 2e-2,
          f"a bucket row's UNet call is {gap_bf16['unet_call_share']:.3g} of scale from its solo call (bf16)")
    check(gap_f32["decoded_share"] <= 2e-2,
          f"a bucket row's float32 image is {gap_f32['decoded_share']:.3g} of scale from its solo render")
    check(all(v["shape"] == [512, 512, 3] for v in per_sampler.values()) and async_shape == [512, 512, 3],
          f"image shapes {per_sampler} {async_shape}")
    check(reload_info["status"] == "reloaded" and reload_info["checkpoint"].endswith("checkpoint-1")
          and final["reloads"] == 1, f"/reload answered {reload_info}, reloads {final['reloads']}")
    check(res["reload_changed_image"] and res["reload_repeat_identical"] and res["serving_after_bad_reload"],
          "the hot swap did not give a new, repeatable image, or serving stopped after a bad reload")
    check(all(launches[k] > 0 for k in SLICE_KERNELS), f"a kernel was not launched by the serve phase: {launches}")
    return res


def phase_train(trainer, name: str, image_size: int, batch: int, required, allocated_before_gb: float,
                steps: int = TRAIN_STEPS) -> dict:
    """Train ``steps`` optimizer steps with the trainer, alone on the card
    (``allocated_before_gb``: what its own build holds), then profile one
    more accumulation window and count the launches of one more micro step
    alone (``launches_per_micro_step``, with each kernel's batch sizes)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    state = trainer.state
    watch = [n for n in state.names if n.endswith(("conv_in.weight", "out.2.weight", "middle_block.1.proj_in.weight"))]
    watch += [state.names[i] for i in range(0, len(state.names), 97)]
    before = {n: p.detach().clone() for n, p in zip(state.names, state.params) if n in watch}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counters()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(trainer.tracker.jsonl_path) as f:
        records = [json.loads(line) for line in f]
    changed = {n: (p.detach() - before[n]).abs().max().item() for n, p in zip(state.names, state.params)
               if n in before}
    train_recs = [r for r in records if "train_loss" in r]
    eval_recs = [r for r in records if "eval_loss" in r]
    losses = [r["train_loss"] for r in train_recs] + [r["eval_loss"] for r in eval_recs]
    timer = trainer.step_timer
    micro = steps * trainer.cfg.train.gradient_accumulation_steps
    res = {
        "phase": name, "gpu": gpu_line(), "image_size": image_size, "batch": batch,
        "gradient_accumulation_steps": trainer.cfg.train.gradient_accumulation_steps,
        "optimizer_steps": state.optimizer.count, "micro_steps": state.step, "dtype": str(trainer.dtype),
        "param_dtype": str(state.params[0].dtype), "n_params": sum(p.numel() for p in state.params),
        "train_loss": [r["train_loss"] for r in train_recs], "eval_loss": [r["eval_loss"] for r in eval_recs],
        "lr": [r["lr"] for r in train_recs], "finite": all(math.isfinite(v) for v in losses),
        "max_param_change": changed, "launches": launches,
        "step_ms_p50": timer.percentile(50) * 1e3, "step_ms_samples": len(timer.durations),
        "samples_per_s": batch / timer.percentile(50), "total_s": total_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "allocated_at_start_gb": allocated_before_gb,
        "optimizer": type(state.optimizer).__name__, "optimizer_layout": state.optimizer.layout(),
        "optimizer_state_bytes": state.optimizer.state_bytes(),
        "remat": trainer.model.unet.remat if hasattr(trainer, "model") else None,
    }
    k9_want = steps if "adam8bit_update" in required else 0  # one launch per optimizer step
    res["ok"] = (res["finite"] and len(train_recs) == steps and len(eval_recs) == 1
                 and state.step == micro and all(v > 0 for v in changed.values())
                 and all(launches[k] > 0 for k in required) and launches["adam8bit_update"] == k9_want)
    emit(res)
    check(len(train_recs) == steps and state.step == micro, f"train ran {state.step} micro steps")
    check(res["finite"], f"non-finite loss: {losses}")
    check(all(v > 0 for v in changed.values()), f"parameters did not change: {changed}")
    check(all(launches[k] > 0 for k in required), f"a kernel was not launched by the {name} run: {launches}")
    check(launches["adam8bit_update"] == k9_want,
          f"K9 ran {launches['adam8bit_update']} times in the {name} run, want {k9_want} (once per optimizer step)")
    check(res["ok"], f"{name} phase check failed")
    t_profile = time.perf_counter()
    res["profile"] = profile_window(trainer)
    res["profile_s"] = time.perf_counter() - t_profile
    emit({"phase": f"{name}_profile", **{k: v for k, v in res["profile"].items() if k != "top_kernels"}})
    # one more micro step, counted alone (no update: the window restarts)
    batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
    torch.cuda.synchronize()
    native.reset_counters()
    trainer._train_step(batch_in, step_generator("cuda", 8))
    torch.cuda.synchronize()
    res["launches_per_micro_step"] = launch_counts()
    res["micro_step_batch_sizes"] = {k: sorted({key[0] for key in native.COUNTERS[k].shapes}) for k in TPU_KERNELS}
    return res


# kernel-name substrings -> category of the training profile, first match wins
PROFILE_CATEGORIES = [
    ("K9 int8 Adam", ("adam8bit",)),
    ("K1 flash attention fwd", ("fa_forward_kernel", "fa_forward_wgmma")),
    ("attention bwd stats pass (K3, K4/K5)", ("bwd_stats_wgmma",)),
    ("K4/K5 split attention bwd", ("split_dq_kernel", "split_dkv_kernel", "split_delta_kernel",
                                   "split_dq_wgmma", "split_dkv_wgmma")),
    ("K3 flash attention bwd", ("fused_bwd_wgmma", "dkv_kernel", "delta_kernel", "cast_kernel<")),
    ("K7 GroupNorm bwd", ("gn_bwd_cluster",)),
    ("K6 GroupNorm fwd", ("gn_fwd_cluster",)),
    ("K8 GroupNorm-concat fwd", ("gn_cat_cluster",)),
    ("optimizer and accumulation (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
    ("other elementwise and reductions", ("elementwise", "vectorized", "reduce", "softmax", "norm", "index")),
]


def profile_device(fn, units: int, unit: str) -> dict:
    """torch.profiler around ``fn()``, a window of ``units`` steps: device ms
    per step by kernel category, and the device's busy share of the window's
    wall time (the profiler's own cost included). Only the device is traced:
    with the host's ops traced too, reading one SD-1.5 training window's
    records took ~19 s against ~5 s, and the window's wall time grew by
    about half."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, kernels, top = {}, 0, []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us <= 0:
            continue
        name = e.key.lower()
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(k in name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + us / 1e3 / units
        kernels += e.count
        top.append((us / 1e3 / units, cat, e.key[:100]))
    busy = sum(cats.values()) * units
    if busy <= 0:
        return {"measured": False, f"wall_ms_per_{unit}": wall_ms / units}
    return {"measured": True, f"{unit}s": units, f"wall_ms_per_{unit}": wall_ms / units,
            f"device_ms_per_{unit}": busy / units, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            f"kernel_launches_per_{unit}": kernels / units,
            "device_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "category": c, "name": n} for ms, c, n in sorted(top, reverse=True)[:25]]}


def profile_window(trainer) -> dict:
    """One accumulation window (its micro steps and the optimizer update)
    after the train run, profiled."""
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    accum = trainer.cfg.train.gradient_accumulation_steps
    it = iter(trainer.train_loader)
    batches = [trainer._place_batch(next(it)) for _ in range(accum)]
    del it

    def window():
        for i, batch in enumerate(batches):
            trainer._train_step(batch, step_generator("cuda", 7, i))

    return profile_device(window, accum, "micro_step")


# --------------------------------------------------------------------------- #
# phase 9c: the personalization trainers
# --------------------------------------------------------------------------- #


def _host_copy(modules: dict) -> dict:
    return {name: {k: t.detach().cpu().clone() for k, t in m.state_dict().items()} for name, m in modules.items()}


def _personalize_round_trip(trainer, kind: str, work: str) -> dict:
    """The run's ``checkpoint-2`` loaded by the sampling side's loaders, each
    image (``STEPS`` DDIM steps, CFG 7.5, seed 42, through the sampling form
    of the training build, ``models/build.py:sampling_model``) against the
    untrained model's on the same base: a LoRA through
    ``load_unet_weights(lora=)`` over the base saved as a UNet checkpoint
    (against the base alone), the concept through
    ``CLIPModel.load_textual_inversion`` (against its initial vectors), the
    ControlNet through ``load_controlnets`` with an edge hint (against no
    control: its zero convs start at zero)."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, UnetConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import load_controlnets, load_unet_weights, sampling_model
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint
    from stable_diffusion_pytorch_tpu_torch.utils.data import edge_hint

    model, cfg = trainer.model, trainer.cfg
    ckpt, size = cfg.checkpoint.ckpt_dir, cfg.dataset.resolution
    prompt = {"dreambooth_lora": "a photo of sks toy", "textual_inversion": "a photo of a <concept> on a table",
              "controlnet": "a red circle on a gradient background"}[kind]

    def run(name, nets=(), **kw):
        sm = sampling_model(model)
        if nets:
            sm.attach_controlnet(list(nets))
        return _feature_run(sm, name, lambda: pipeline.sample(
            sm, prompt=prompt, image_size=size, time_steps=STEPS, guidance_scale=7.5, save_dir=None, seed=42, **kw),
            nets)

    untrained = run("untrained")
    nets, kw = (), {}
    if kind == "dreambooth_lora":
        base = os.path.join(work, "base_unet")
        save_checkpoint(os.path.join(base, "checkpoint-0"),
                        {"step": 0, "params": model.unet.state_dict(), "ema_params": None})
        loaded = load_unet_weights(model.unet, base, lora=ckpt)
    elif kind == "textual_inversion":
        loaded = model.text_encoder.load_textual_inversion(ckpt)
    else:
        nets = load_controlnets([ckpt], UnetConfig(**cfg.model.unet.to_dict()),
                                AutoencoderConfig(**cfg.model.autoencoder.to_dict()), dtype=model.dtype,
                                device=model.device)
        pixels = smoke_image(4, size).astype(np.float32) / 127.5 - 1.0
        kw["control_image"] = ((edge_hint(pixels) + 1.0) * 127.5).astype(np.uint8)
        loaded = ckpt
    trained = run("trained", nets, **kw)
    diff = (trained["_image"] - untrained["_image"]).abs().max().item()
    rec = {"loaded": str(loaded), "steps": STEPS, "max_abs_vs_untrained": diff,
           **{f"{name}_{k}": r[k] for name, r in (("untrained", untrained), ("trained", trained))
              for k in ("decoded_shape", "finite", "s_per_step", "launches")}}
    rec["ok"] = (trained["decoded_shape"] == [1, size, size, 3] and trained["finite"] and untrained["finite"]
                 and diff > 0)
    del untrained, trained, nets
    free_cuda()
    torch.cuda.synchronize()
    return rec


def phase_personalize(work: str) -> dict:
    """Phase 9c: DreamBooth with LoRA (rank 8) and prior preservation on the
    int8 optimizer, textual inversion and ControlNet training, each through
    its entry point at SD-1.5 width, 512x512, UNet batch 4, bf16 over f32,
    accumulation 4, two optimizer steps and one evaluation, built where it
    runs and freed after (``build_personalize_trainer``). Each: phase 7's
    record and checks (finite losses, kernels launched, K9 once per optimizer
    step in the DreamBooth run, samples/s, step ms p50, peak memory,
    optimizer-state bytes, profile); the launches of one more micro step; the
    frozen UNet, VAE and CLIP bit-identical after the run; which trainable
    tensors moved at each optimizer step (weight decay 0: a tensor without
    gradient stays put): LoRA's B at step 1 and A only at step 2 (B starts at
    zero), the concept at step 1, the ControlNet's zero convs at step 1 and
    the encoder copy only at step 2; then the checkpoint round trip
    (``_personalize_round_trip``)."""
    import torch

    runs, failures = {}, []
    for kind in PERSONALIZE_RUNS:
        run_work = f"{work}_{kind}"
        t0 = time.perf_counter()
        trainer = build_personalize_trainer(kind, run_work)
        build_s = time.perf_counter() - t0
        state, model = trainer.state, trainer.model
        frozen = {"unet": model.unet, "text_encoder": model.text_encoder.module, "autoencoder": model.autoencoder}
        before = _host_copy(frozen)
        start = [p.detach().clone() for p in state.params]
        after_update, orig_step = [], state.optimizer.step

        def step(grads, orig_step=orig_step, after_update=after_update, state=state):
            applied, norm = orig_step(grads)
            if applied:
                after_update.append([p.detach().clone() for p in state.params])
            return applied, norm

        state.optimizer.step = step
        res = phase_train(trainer, kind, PERSONALIZE_SIZE, PERSONALIZE_BATCH, PERSONALIZE_KERNELS[kind], free_cuda())
        state.optimizer.step = orig_step
        after = _host_copy(frozen)
        res["frozen_unchanged"] = {name: all(torch.equal(t, after[name][k]) for k, t in tensors.items())
                                   for name, tensors in before.items()}
        del before, after
        moved = [[not torch.equal(a, b) for a, b in zip(start, snap)] for snap in after_update[:TRAIN_STEPS]]
        # "early": the tensors with a gradient from the first step (LoRA's B, the
        # concept, the zero convs); "late": those whose gradient passes through
        # an early one that starts at zero (LoRA's A, the encoder copy). The
        # ControlNet's hint block is neither: its output conv starts at zero
        # and moves at step 2, the convs before it only at step 3.
        names = state.names
        if kind == "dreambooth_lora":
            group = ["early" if n.endswith(".lora_b") else "late" for n in names]
        elif kind == "controlnet":
            copied = set(model.unet.state_dict())
            group = ["early" if n.startswith(("zero_convs.", "middle_block_out.")) else
                     "late" if n in copied else "hint" for n in names]
        else:
            group = ["early"] * len(names)
        res["moved_at_step"] = {f"{g}_at_{i + 1}": sum(m for m, h in zip(moved[i], group) if h == g)
                                for g in ("early", "late", "hint") for i in range(TRAIN_STEPS)}
        res["moved_at_step"].update({g: group.count(g) for g in ("early", "late", "hint")})
        mv = res["moved_at_step"]
        res["trainables"] = {"n_tensors": len(names), "n_params": res["n_params"], "shapes": sorted(
            {tuple(p.shape) for p in state.params})[:12]}
        del start, after_update
        res["build_s"] = build_s
        res["round_trip"] = _personalize_round_trip(trainer, kind, run_work)
        checks = {"frozen_unchanged": all(res["frozen_unchanged"].values()),
                  "early_moved_at_step_1": mv["early_at_1"] == mv["early"],
                  "late_still_at_step_1": mv["late_at_1"] == 0, "late_moved_at_step_2": mv["late_at_2"] == mv["late"],
                  "round_trip": res["round_trip"]["ok"]}
        res["checks"] = checks
        runs[kind] = res
        if not all(checks.values()):
            failures.append(kind)
        del trainer, state, model, frozen
        free_cuda()
    out = {"phase": "personalize", "gpu": gpu_line(), "image_size": PERSONALIZE_SIZE, "unet_batch": PERSONALIZE_BATCH,
           "ok": not failures, "runs": runs}
    emit({**out, "runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("max_param_change", "profile")}
                          for k, v in runs.items()}})
    check(not failures, f"personalize checks failed for {failures}: "
          f"{ {k: runs[k]['checks'] for k in failures} }")
    return out


# --------------------------------------------------------------------------- #
# phase 9d: the rest of the trainers' options
# --------------------------------------------------------------------------- #


def _decodes():
    """Record the shape and finiteness of every ``LatentDiffusion.decode_latent``
    output until the returned ``stop()`` (the images ``--log-image`` samples)."""
    from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion

    seen, real = [], LatentDiffusion.decode_latent

    def decode_latent(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        seen.append({"shape": list(out.shape), "finite": bool(out.float().isfinite().all())})
        return out

    LatentDiffusion.decode_latent = decode_latent

    def stop():
        LatentDiffusion.decode_latent = real
        return seen

    return stop


def _objective_run(work: str, train_ref: dict) -> dict:
    """(a) v-prediction on the zero-terminal-SNR schedule, Min-SNR 5, the
    gradient noise scale, spike detection and ``--log-image``, 5 optimizer
    steps at accumulation 2, the evaluation and the logged sample on the
    last: ``grad_noise_scale`` recorded at step 5; a micro step launches K1,
    the split set, K6, K7 and K8 exactly twice as often as train 512's (each
    half batch runs the VAE encoder and the UNet forward and backward), every
    K1 and split-set launch at the half batch; the logged sample decodes to a
    finite [1, 512, 512, 3]."""
    trainer = build_sd15_trainer(work, 512, TRAIN_BATCH, OBJECTIVE_FLAGS)
    stop = _decodes()
    try:
        res = phase_train(trainer, "train_options_objective", 512, TRAIN_BATCH, TRAIN_KERNELS, free_cuda(),
                          steps=OBJECTIVE_STEPS)
    finally:
        decodes = stop()
    with open(trainer.tracker.jsonl_path) as f:
        records = [json.loads(line) for line in f if "train_loss" in line]
    res["grad_noise_scale"] = [r.get("grad_noise_scale") for r in records]
    res["loss_spikes"] = [r["loss_spike"] for r in records if "loss_spike" in r]
    res["logged_decodes"] = decodes
    per, ref = res["launches_per_micro_step"], train_ref["launches_per_micro_step"]
    doubled = ("flash_attention", "flash_attention_bwd_split", "group_norm", "group_norm_bwd", "group_norm_cat")
    res["vs_train_per_micro_step"] = {k: [per[k], ref[k]] for k in doubled}
    half = TRAIN_BATCH // 2
    res["checks"] = {
        "grad_noise_scale_at_step_5": len(records) == OBJECTIVE_STEPS and records[-1].get("grad_noise_scale")
        is not None and all(r.get("grad_noise_scale") is None for r in records[:-1]),
        "twice_train_per_micro_step": all(per[k] == 2 * ref[k] > 0 for k in doubled),
        "half_batch": all(res["micro_step_batch_sizes"][k] == [half]
                          for k in ("flash_attention", "flash_attention_bwd_split")),
        "logged_image": decodes == [{"shape": [1, 512, 512, 3], "finite": True}],
        "gns_finite": math.isfinite(records[-1].get("grad_noise_scale") or math.nan),
    }
    del trainer
    return res


def _cache_run(work: str, train_ref: dict) -> dict:
    """(b) ``--latent-cache``: the cache built on the card from ``CACHE_ROWS``
    synthetic rows with the text embeddings, then 2 optimizer steps from it.
    The file's moments are [16, 64, 64, 8]; a micro step calls neither the
    VAE encoder nor CLIP, and its K1, K6 and K8 equal one UNet call's block
    plan; its launches, beside train 512's, fall by the encoder's and CLIP's."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    cache = os.path.join(work, "latents.npz")
    t0 = time.perf_counter()
    trainer = build_sd15_trainer(work, 512, TRAIN_BATCH, ("--latent-cache", cache,
                                                          "--max-train-samples", str(CACHE_ROWS)))
    build_s = time.perf_counter() - t0
    with np.load(cache) as data:
        layout = {k: [list(data[k].shape), str(data[k].dtype)] for k in data}
    res = phase_train(trainer, "train_options_cache", 512, TRAIN_BATCH, TRAIN_KERNELS, free_cuda())
    calls = {"vae_encoder": 0, "clip": 0}

    def counting(name):
        return lambda *_: calls.__setitem__(name, calls[name] + 1)

    hooks = [trainer.model.autoencoder.encoder.register_forward_pre_hook(counting("vae_encoder")),
             trainer.model.text_encoder.module.register_forward_pre_hook(counting("clip"))]
    batch_in = trainer._place_batch(next(iter(trainer.train_loader)))
    torch.cuda.synchronize()
    native.reset_counters()
    trainer._train_step(batch_in, step_generator("cuda", 6))
    torch.cuda.synchronize()
    per = launch_counts()
    for h in hooks:
        h.remove()
    plan = feature_plans(presets.sd15_unet_config())["unet_call"]
    launches = res["profile"].get("kernel_launches_per_micro_step")
    ref_launches = train_ref["profile"].get("kernel_launches_per_micro_step")
    res.update({"cache_layout": layout, "build_with_cache_s": build_s, "batch_keys": sorted(batch_in),
                "calls_per_micro_step": calls, "launches_per_micro_step": per, "unet_plan": plan,
                "kernel_launches_per_micro_step": [launches, ref_launches]})
    res["checks"] = {
        "moments": layout.get("moments") == [[CACHE_ROWS, 64, 64, 8], "float32"],
        "text_cached": layout.get("context_emb") == [[CACHE_ROWS, 77, 768], "float16"],
        "no_encoder_no_clip": calls == {"vae_encoder": 0, "clip": 0} and "moments" in batch_in,
        "unet_plan": all(per[k] == plan[k] for k in plan),
        "fewer_launches": launches is not None and ref_launches is not None and launches < ref_launches,
    }
    del trainer, batch_in
    return res


def _preprocess_runs(work: str) -> dict:
    """(c) ``--device-preprocess --random-flip``: the UNet trainer and the VAE
    trainer (with the gradient noise scale) at 256x256 batch 4 from uint8
    rows; ``device_preprocess`` on the card against its CPU run, a batch of
    non-square [4, 300, 400, 3] rows and one of the run's, with flips."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch.utils.preprocess import device_preprocess

    out = {}
    trainer = build_sd15_trainer(f"{work}_unet", PREPROCESS_SIZE, TRAIN_BATCH, PREPROCESS_FLAGS)
    first = next(iter(trainer.train_loader))
    out["unet"] = phase_train(trainer, "train_options_preprocess_unet", PREPROCESS_SIZE, TRAIN_BATCH, TRAIN_KERNELS,
                              free_cuda())
    del trainer
    free_cuda()
    trainer = build_sd15_vae_trainer(f"{work}_vae", PREPROCESS_SIZE, TRAIN_BATCH,
                                     (*PREPROCESS_FLAGS, "--log-grad-noise-scale"))
    out["vae"] = phase_train(trainer, "train_options_preprocess_vae", PREPROCESS_SIZE, TRAIN_BATCH,
                             VAE_TRAIN_KERNELS, free_cuda())
    del trainer
    free_cuda()
    errs = {}
    for name, raw in (("non_square", np.random.default_rng(0).integers(0, 256, (4, 300, 400, 3), np.uint8)),
                      ("run_rows", first["raw_images"])):
        raw = torch.from_numpy(np.ascontiguousarray(raw))
        flip = torch.arange(raw.shape[0]) % 2 == 0
        cpu = device_preprocess(raw, PREPROCESS_SIZE, random_flip=True, flip=flip)
        card = device_preprocess(raw.cuda(), PREPROCESS_SIZE, random_flip=True, flip=flip.cuda())
        errs[name] = (card.cpu() - cpu).abs().max().item()
    out["card_vs_cpu_max_abs"] = errs
    half = [TRAIN_BATCH // 2]
    out["checks"] = {"raw_rows": first["raw_images"].dtype == np.uint8 and "pixel_values" not in first,
                     "card_vs_cpu": all(e <= PREPROCESS_TOL for e in errs.values()),
                     "vae_gns_half_batch": all(out["vae"]["micro_step_batch_sizes"][k] == half
                                               for k in ("flash_attention", "flash_attention_bwd_split"))}
    return out


def _chain_run(work: str) -> dict:
    """(d) ``--no-fused-adamw``, accumulation 2, 2 optimizer steps; a fused
    ``AdamW`` over copies of the starting parameters takes the same gradients
    at every micro step: after step 2 the two paths' parameters agree within
    ``CHAIN_TOL_LR`` of the learning rate beyond ``CHAIN_TOL_REL`` of their
    size (``trainers/optim.py:ChainAdamW``)."""
    import types

    import torch

    from stable_diffusion_pytorch_tpu_torch.trainers import optim

    trainer = build_sd15_trainer(work, 512, TRAIN_BATCH, CHAIN_FLAGS)
    state, cfg = trainer.state, trainer.cfg
    check(isinstance(state.optimizer, optim.ChainAdamW), f"--no-fused-adamw built {type(state.optimizer).__name__}")
    shadow_params = [p.detach().clone() for p in state.params]
    shadow = optim.build_optimizer(shadow_params, types.SimpleNamespace(**{**cfg.optim.to_dict(),
                                                                           "no_fused_adamw": False}),
                                   max_train_steps=cfg.train.max_train_steps,
                                   gradient_accumulation_steps=cfg.train.gradient_accumulation_steps)
    check(type(shadow) is optim.AdamW, "the shadow optimizer is the fused AdamW")
    chain_step, seen = state.optimizer.step, {}

    def step(grads):
        shadow.step(grads)
        applied, norm = chain_step(grads)
        if applied and state.optimizer.count == TRAIN_STEPS:
            seen["max_abs_diff"] = max((a - b).abs().max().item() for a, b in zip(state.params, shadow_params))
            seen["max_excess"] = max(((a - b).abs() - CHAIN_TOL_REL * b.abs()).max().item()
                                     for a, b in zip(state.params, shadow_params))
            seen["max_abs_param"] = max(p.abs().max().item() for p in state.params)
        return applied, norm

    state.optimizer.step = step
    try:
        res = phase_train(trainer, "train_options_chain", 512, TRAIN_BATCH, TRAIN_KERNELS, free_cuda())
    finally:
        state.optimizer.step = chain_step
    lr = float(cfg.optim.learning_rate)
    res["vs_fused"] = {**seen, "lr": lr, "tol": CHAIN_TOL_LR * lr}
    res["checks"] = {"layout": res["optimizer_layout"].get("no_fused_adamw") is True
                     and res["optimizer_layout"].get("accum_dtype") == "f32",
                     "vs_fused": seen.get("max_excess", math.inf) <= CHAIN_TOL_LR * lr}
    del trainer, state, shadow, shadow_params
    torch.cuda.synchronize()
    return res


def phase_train_options(work: str, train_ref: dict) -> dict:
    """Phase 9d: the rest of the trainers' options at SD-1.5 width through the
    entry points' ``build_trainer``, each run built where it runs and freed
    (``_objective_run``, ``_cache_run``, ``_preprocess_runs``, ``_chain_run``),
    each with phase 7's record and checks and its own; ``train_ref`` is
    train 512's record (batch 4, its launches per micro step)."""
    t0 = time.perf_counter()
    runs = {"objective": _objective_run(f"{work}_objective", train_ref)}
    free_cuda()
    runs["cache"] = _cache_run(f"{work}_cache", train_ref)
    free_cuda()
    pre = _preprocess_runs(f"{work}_preprocess")
    runs["preprocess_unet"], runs["preprocess_vae"] = pre.pop("unet"), pre.pop("vae")
    runs["preprocess_unet"].update(pre)
    free_cuda()
    runs["chain"] = _chain_run(f"{work}_chain")
    free_cuda()
    failures = {k: {c: ok for c, ok in r["checks"].items() if not ok} for k, r in runs.items() if "checks" in r}
    failures = {k: v for k, v in failures.items() if v}
    out = {"phase": "train_options", "gpu": gpu_line(), "seconds": time.perf_counter() - t0, "ok": not failures,
           "runs": runs}
    emit({**out, "runs": {k: {kk: vv for kk, vv in v.items() if kk not in ("max_param_change", "profile")}
                          for k, v in runs.items()}})
    check(not failures, f"train_options checks failed: {failures}")
    return out


# --------------------------------------------------------------------------- #
# phase 9e: staged pretrained weights and evaluation
# --------------------------------------------------------------------------- #


def staged_state(name: str, device="cuda") -> dict:
    """{key: CPU tensor} of one staged file (``STAGED``), made from its own
    generator on ``device`` in its real layout: ``unet`` the SD-1.5 UNet in
    reference names (zero layers filled), ``vae`` the SD-1.5 diffusers VAE in
    diffusers names, ``text_encoder`` an HF CLIPTextModel (``position_ids``
    included), ``inception`` a torchvision ``inception_v3`` (conv weights and
    BatchNorm statistics, fc and AuxLogits left out), ``clip_full`` an HF
    CLIPModel at ViT-L/14 width (both projections, ``logit_scale``). The same
    call gives the same tensors."""
    import torch
    from torch import nn

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import without_default_init, init_weights
    from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPTextTransformer
    from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPVisionTransformer
    from stable_diffusion_pytorch_tpu_torch.models.diffusers_vae import DEFAULT_CONFIG, DiffusersAutoencoderKL
    from stable_diffusion_pytorch_tpu_torch.models.inception import BasicConv2d, InceptionV3Pool3
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel

    gen = torch.Generator(device=device).manual_seed(STAGE_SEED + STAGED.index(name))
    vae_cfg = presets.sd15_autoencoder_config()
    with torch.device(device), without_default_init():
        module = {
            "unet": lambda: UNetModel(vae_cfg.latent_channels, vae_cfg.groups, presets.sd15_unet_config()),
            "vae": lambda: DiffusersAutoencoderKL(**DEFAULT_CONFIG),  # SD-1.5's, as stage_pretrained writes it
            "text_encoder": CLIPTextTransformer,
            "inception": InceptionV3Pool3,
            "clip_full": lambda: nn.ModuleList([CLIPTextTransformer(), CLIPVisionTransformer()]),  # ViT-L/14
        }[name]()
    init_weights(module, gen)
    state = {}
    with torch.no_grad():
        if name == "unet":
            fill_zero_weights(module, gen)
        elif name == "inception":
            for prefix, m in module.named_modules():
                if isinstance(m, BasicConv2d):
                    w, c = m.conv.weight, m.conv.weight.shape[0]
                    w.normal_(0.0, (2.0 / w[0].numel()) ** 0.5, generator=gen)
                    stats = torch.randn(4, c, device=device, generator=gen)
                    state.update({f"{prefix}.conv.weight": w, f"{prefix}.bn.weight": 1.0 + 0.1 * stats[0],
                                  f"{prefix}.bn.bias": 0.1 * stats[1], f"{prefix}.bn.running_mean": 0.1 * stats[2],
                                  f"{prefix}.bn.running_var": 0.75 + 0.25 * stats[3].abs()})
        elif name == "clip_full":
            text, vision = module
            vision.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
            state = {**text.state_dict(), **vision.state_dict()}
            for key, d in (("text_projection.weight", text.d_model), ("visual_projection.weight", vision.d_model)):
                state[key] = torch.randn(768, d, device=device, generator=gen) * d ** -0.5
            state["logit_scale"] = torch.tensor(2.6592, device=device)
            n_patches = state["vision_model.embeddings.position_embedding.weight"].shape[0]
            state["vision_model.embeddings.position_ids"] = torch.arange(n_patches, device=device)[None]
        if name in ("text_encoder", "clip_full"):
            state["text_model.embeddings.position_ids"] = torch.arange(77, device=device)[None]
    state = state if name in ("inception", "clip_full") else {**module.state_dict(), **state}
    return {k: v.detach().to("cpu", copy=True).contiguous() for k, v in state.items()}


def stage_pretrained(root: str) -> dict:
    """Write every ``STAGED`` file under ``root`` as a user stages them for
    ``--model-dir``: ``unet.pt`` (torch), ``vae/config.json`` with
    ``diffusion_pytorch_model.bin`` (torch), ``text_encoder/model.safetensors``
    and ``clip_full/model.safetensors`` (the port's writer),
    ``inception/inception_v3.pth`` (torch) -> {file: GB}, seconds."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.models.diffusers_vae import DEFAULT_CONFIG
    from stable_diffusion_pytorch_tpu_torch.utils.safetensors import save_file

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    paths = {"unet": "unet.pt", "vae": "vae/diffusion_pytorch_model.bin",
             "text_encoder": "text_encoder/model.safetensors", "inception": "inception/inception_v3.pth",
             "clip_full": "clip_full/model.safetensors"}
    sizes = {}
    for name in STAGED:
        path = os.path.join(root, paths[name])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        state = staged_state(name)
        if path.endswith(".safetensors"):
            save_file(state, path)
        else:
            torch.save(state, path)
        sizes[paths[name]] = os.path.getsize(path) / 1e9
        del state
    cfg = {**DEFAULT_CONFIG, "block_out_channels": list(DEFAULT_CONFIG["block_out_channels"])}
    cfg["norm_num_groups"] = cfg.pop("groups")
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump({"_class_name": "AutoencoderKL", **cfg}, f)
    free_cuda()
    return {"root": root, "gb": sizes, "seconds": time.perf_counter() - t0}


def eval_images(shift: float = 0.0):
    """The evaluation set: ``EVAL_IMAGES`` seeded smooth 512x512 images in
    [-1, 1] (f32), every pixel moved by ``shift`` and clipped."""
    import numpy as np

    images = np.stack([smoke_image(200 + i) for i in range(EVAL_IMAGES)]).astype(np.float32) / 127.5 - 1.0
    return np.clip(images + shift, -1.0, 1.0)


def eval_prompts():
    return [f"a photograph of pattern number {i}" for i in range(EVAL_IMAGES)]


def eval_probes(stage: str, collect) -> None:
    """Phase 9e's launch shapes, ``collect()`` after each: the staged
    diffusers VAE's decode of a 64x64 latent in bf16 (cast as ``build_models``
    casts it: K6 at eps 1e-6, K1 at its mid block's head of 512) and one
    ``CLIPScorer`` batch of ``EVAL_BATCH`` (the ViT-L/14 tower in f32: K1 at
    [16, 257, 257, 16, 64])."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
    from stable_diffusion_pytorch_tpu_torch.models.build import cast_for_inference
    from stable_diffusion_pytorch_tpu_torch.models.clip import resolve_tokenizer
    from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPScorer
    from stable_diffusion_pytorch_tpu_torch.models.diffusers_vae import load_diffusers_vae

    vae = cast_for_inference(load_diffusers_vae(os.path.join(stage, "vae"), "cuda"), torch.bfloat16)
    with torch.inference_mode():
        vae.decode(torch.randn(1, 64, 64, 4, device="cuda", dtype=torch.bfloat16))
    collect()
    del vae
    scorer = CLIPScorer(resolve_tokenizer(ClipConfig(model_dir=stage)), model_dir=stage, device="cuda")
    images = ((eval_images()[:EVAL_BATCH] + 1.0) * 127.5).round().astype(np.uint8)
    scorer.similarities(images, eval_prompts()[:EVAL_BATCH], batch=EVAL_BATCH)
    collect()
    del scorer
    free_cuda()


class _LogLines:
    """Collects the messages of one logger while installed."""

    def __init__(self, name: str):
        import logging

        self.lines = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _loaded_bits(module, written: dict, dtype) -> list:
    """The parameters of ``module`` that are not ``written`` cast as
    ``cast_for_inference`` casts (GroupNorm affine f32 as written, the rest
    ``dtype``), bit for bit (the first 8 names); [] when all are."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.models.blocks import GroupNorm

    gn = {f"{n}.{k}" for n, m in module.named_modules() if isinstance(m, GroupNorm) for k in ("weight", "bias")}
    bad = []
    for name, p in module.state_dict().items():
        want = written[name].to(torch.float32 if name in gn else dtype)
        if p.dtype != want.dtype or not torch.equal(p.cpu(), want):
            bad.append(name)
    return bad[:8]


def _staged_txt2img(stage: str, work: str) -> dict:
    """(a) txt2img's ``main`` with ``--model-dir`` at the staged directory."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch.models.blocks import GroupNorm
    from stable_diffusion_pytorch_tpu_torch.models.clip import tower_state
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.scripts import txt2img

    argv = [*SD15_FLAGS, "--model-dir", stage, "--device", "cuda", "--mixed-precision", "bf16", "--seed", str(SEED),
            "--prompt", SERVE_PROMPT, "--image-size", "512", "--sampling-steps", str(STEPS), "--sampler", "ddim",
            "--guidance-scale", "7.5", "--output-dir", work, "--output-name", "staged.png"]
    torch.cuda.synchronize()
    native.reset_counters()
    t0 = time.perf_counter()
    with _LogLines("txt2img") as lines:
        model = txt2img.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    k1_shapes = dict(native.COUNTERS["flash_attention"].shapes)
    res = {"launches": launches, "total_s": total_s, "log": [ln for ln in lines if "pretrained" in ln]}
    # each loaded tensor as written, through the cast
    res["not_as_written"] = {
        "unet": _loaded_bits(model.unet, staged_state("unet"), model.dtype),
        "vae": _loaded_bits(model.autoencoder, staged_state("vae"), model.dtype),
        "text_encoder": _loaded_bits(model.text_encoder.module, tower_state(staged_state("text_encoder")),
                                     model.dtype),
    }
    # the decode alone: its launches against the diffusers plan, its time
    latent = torch.randn(1, 64, 64, 4, device="cuda", dtype=model.dtype, generator=torch.Generator("cuda").manual_seed(1))
    native.reset_counters()
    with torch.inference_mode():
        model.autoencoder.decode(latent)
        torch.cuda.synchronize()
        res["decode_launches"] = {"flash_attention": {str(k): n for k, n in native.COUNTERS["flash_attention"].shapes.items()},
                                  "group_norm": native.COUNTERS["group_norm"].count}
        res["decode_gn_plan"] = sum(isinstance(m, GroupNorm) for m in model.autoencoder.decoder.modules())
        res["decode_ms"] = cuda_ms(lambda: model.autoencoder.decode(latent), iters=2, repeats=3)
        ctx = model.encode_prompts([SERVE_PROMPT])
        noise = torch.randn(model.latent_shape(1, 512), device="cuda", dtype=model.dtype)
        _, loop_s = _timed(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=STEPS, sampler="ddim"))
    res["s_per_step"] = loop_s / STEPS
    png = _png_file(os.path.join(work, "staged.png"))
    res.update(png_shape=list(png.shape), png_std=float(np.asarray(png, np.float32).std()))
    decode_key = (1, 4096, 4096, 1, 512, "torch.bfloat16")
    res["checks"] = {
        "loaded_all_three": any("pretrained weights loaded: ['unet', 'vae', 'clip'] (diffusers AutoencoderKL" in ln
                                for ln in res["log"]),
        "bit_exact": not any(res["not_as_written"].values()),
        "k1_in_decode": k1_shapes.get(decode_key, 0) >= 1,
        "decode_k1": res["decode_launches"]["flash_attention"] == {str(decode_key): 1},
        "decode_k6_plan": res["decode_launches"]["group_norm"] == res["decode_gn_plan"],
        "png": res["png_shape"] == [512, 512, 3] and res["png_std"] > 0,
        "kernels": all(launches[k] > 0 for k in SLICE_KERNELS),
    }
    return res


def _fid_run(stage: str) -> dict:
    """(b) the canonical extractor on the card vs the CPU, FID self vs shifted."""
    import numpy as np
    import torch

    from stable_diffusion_pytorch_tpu_torch.utils.fid import InceptionFeatureExtractor, fid_from_features

    images, shifted = eval_images(), eval_images(EVAL_SHIFT)

    def feats(ext, x):
        return np.concatenate([ext(x[i:i + EVAL_BATCH]) for i in range(0, len(x), EVAL_BATCH)])

    card = InceptionFeatureExtractor(model_dir=stage, device="cuda")
    card_shifted = feats(card, shifted)  # the first call also warms cuDNN up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card_feats, secs = _timed(lambda: feats(card, images))
    peak = torch.cuda.max_memory_allocated() / 2**30
    cpu_feats, cpu_s = _timed(lambda: feats(InceptionFeatureExtractor(model_dir=stage, device="cpu"), images))
    err = float(np.abs(card_feats - cpu_feats).max())
    scale = max(1.0, float(np.abs(cpu_feats).max()))
    fid_self, fid_shift = fid_from_features(card_feats, card_feats), fid_from_features(card_feats, card_shifted)
    res = {"s_per_32_images": secs * 32 / EVAL_IMAGES, "peak_gb": peak, "cpu_s": cpu_s, "feature_err": err,
           "feature_scale": scale, "feature_rel_err": err / scale, "tol": FID_FEATURE_TOL,
           "fid_self": fid_self, "fid_shifted": fid_shift, "feature_shape": list(card_feats.shape)}
    res["checks"] = {"card_vs_cpu": err / scale <= FID_FEATURE_TOL, "finite": bool(np.isfinite(card_feats).all()),
                     "shape": res["feature_shape"] == [EVAL_IMAGES, 2048],
                     "self_below_shifted": abs(fid_self) < FID_SELF_RATIO * fid_shift}
    return res


def _clip_score_run(stage: str) -> dict:
    """(c) CLIPScorer with the staged ViT-L/14, f32, on the card vs the CPU."""
    import numpy as np

    from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
    from stable_diffusion_pytorch_tpu_torch.models.clip import resolve_tokenizer
    from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPScorer
    from stable_diffusion_pytorch_tpu_torch.ops import native

    tok = resolve_tokenizer(ClipConfig(model_dir=stage))
    images = ((eval_images() + 1.0) * 127.5).round().astype(np.uint8)
    prompts = eval_prompts()
    scorer = CLIPScorer(tok, model_dir=stage, device="cuda")
    native.reset_counters()
    sims, first_s = _timed(lambda: scorer.similarities(images, prompts, batch=EVAL_BATCH))
    launches = launch_counts()
    k1 = native.COUNTERS["flash_attention"]
    k1_shapes, k1_impls = {str(k): n for k, n in k1.shapes.items()}, dict(k1.impls)
    _, secs = _timed(lambda: scorer.similarities(images, prompts, batch=EVAL_BATCH))
    del scorer
    free_cuda()
    cpu = CLIPScorer(tok, model_dir=stage, device="cpu")
    cpu_sims, cpu_s = _timed(lambda: cpu.similarities(images, prompts, batch=EVAL_BATCH))
    score, cpu_score = (float(100.0 * np.maximum(s, 0.0).mean()) for s in (sims, cpu_sims))
    layers = 24 * (EVAL_IMAGES // EVAL_BATCH)
    key = str((EVAL_BATCH, 257, 257, 16, 64, "torch.float32"))
    res = {"launches": launches, "k1_shapes": k1_shapes, "k1_impls": k1_impls, "score": score,
           "cpu_score": cpu_score, "max_sim_err": float(np.abs(sims - cpu_sims).max()), "tol": CLIP_SIM_TOL,
           "s_per_image": secs / EVAL_IMAGES, "first_call_s": first_s, "cpu_s": cpu_s}
    res["checks"] = {"k1_vision_fma": k1_shapes == {key: layers} and k1_impls == {"fma": layers},
                     "card_vs_cpu": res["max_sim_err"] <= CLIP_SIM_TOL and abs(score - cpu_score) <= 100 * CLIP_SIM_TOL,
                     "finite": bool(np.isfinite(sims).all())}
    return res


def phase_eval(stage: str, work: str) -> dict:
    """Phase 9e: (a) txt2img from the staged directory, (b) FID with the
    canonical extractor, (c) the CLIP score; each with its checks."""
    t0 = time.perf_counter()
    runs = {"txt2img": _staged_txt2img(stage, work)}
    free_cuda()
    runs["fid"] = _fid_run(stage)
    free_cuda()
    runs["clip_score"] = _clip_score_run(stage)
    free_cuda()
    failures = {k: [c for c, ok in r["checks"].items() if not ok] for k, r in runs.items()}
    failures = {k: v for k, v in failures.items() if v}
    out = {"phase": "eval", "gpu": gpu_line(), "seconds": time.perf_counter() - t0, "ok": not failures, "runs": runs}
    emit(out)
    check(not failures, f"eval checks failed: {failures}")
    return out


# phase 9g: the evaluation and interop tools (scripts/), at the sizes below
TOOLS_SEED = 3
FID_RUN = dict(n_images=16, steps=4, res=32, deep_cache=(3,))  # FID_N, FID_STEPS, FID_RES, FID_DEEP_CACHE
FID_ORDER = 3.0  # fid(compat, default) above this many times the compat floor's magnitude
# fid_samplers cut from FS_N 256, FS_TRAIN_STEPS 400, FS_TARGET_STEPS 200 and
# FS_GRID "ddim:10,20,25,50;dpmpp:10,15,20,25,50;ddpm:25,50"
FS_RUN = dict(n=32, res=32, train_steps=60, target_steps=50, grid="ddim:4,8,16;dpmpp:4,8;ddpm:8", guidance=2.0,
              pool=8)
FS_DDIM = ("ddim", (4, 8, 16))  # its RMSE to the target must fall with the steps
TOOLS_VAE_SIZE = 256  # full_scale_parity's VAE check, cut from the tool's 512
TOOLS_LOOP_LATENT = 32  # its compat loop's latent side, cut from the tool's 64


def _synthetic_tokenizer(root: str) -> None:
    """A CLIP tokenizer directory of the byte vocab and five merges (the JAX
    package's stage-check test recipe)."""
    from stable_diffusion_pytorch_tpu_torch.models.bpe import bytes_to_unicode

    merges = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"), ("o", "n</w>")]
    base = list(bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(base)}
    vocab.update({tok + "</w>": 256 + i for i, tok in enumerate(base)})
    vocab.update({a + b: 512 + i for i, (a, b) in enumerate(merges)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def _tools_stage_check(stage: str, work: str) -> dict:
    """(a) every artifact of the staged directory, linked (not copied) with a
    synthetic tokenizer and the SD-1.5 UNet's ``unet_config.json``: all ok,
    exit 0, the UNet card vs CPU; (b) an empty directory exits 2 with all six
    missing, a ``unet.pt`` of wrong keys exits 1 with it failed."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.scripts import stage_check

    linked = os.path.join(work, "staged")
    os.makedirs(linked)
    for name in ("unet.pt", "vae", "text_encoder", "inception", "clip_full"):
        os.symlink(os.path.join(stage, name), os.path.join(linked, name))
    _synthetic_tokenizer(linked)
    with open(os.path.join(linked, "unet_config.json"), "w") as f:
        json.dump(dataclasses.asdict(presets.sd15_unet_config()), f)
    report = stage_check.run(linked, device="cuda")
    unet = report["checks"]["unet"]
    empty = os.path.join(work, "empty")
    os.makedirs(empty)
    missing = stage_check.run(empty, device="cuda")
    bad = os.path.join(work, "bad")
    os.makedirs(bad)
    torch.save({"conv_in.weight": torch.zeros(320, 4, 3, 3), "time_embedding.0.weight": torch.zeros(1280, 320),
                "not_a_unet.weight": torch.zeros(1)}, os.path.join(bad, "unet.pt"))
    wrong = stage_check.run(bad, ["unet"], device="cuda")
    code, code_empty, code_bad = (stage_check.exit_code(r) for r in (report, missing, wrong))
    out = {"exit": code, "checks_report": {k: {kk: v for kk, v in r.items() if kk != "traceback"}
                                            for k, r in report["checks"].items()},
           "statuses": {k: r["status"] for k, r in report["checks"].items()}, "unet": unet,
           "exit_empty": code_empty, "missing_empty": missing["missing"], "exit_wrong_keys": code_bad,
           "failed_wrong_keys": wrong["failed"]}
    out["checks"] = {"all_ok": code == 0 and set(out["statuses"]) == set(stage_check.CHECKS)
                     and set(out["statuses"].values()) == {"ok"},
                     "unet_cpu_parity": unet.get("mode") == "cpu-parity" and unet.get("max_abs_delta", 1.0) <= unet.get(
                         "tol", 0.0),
                     "empty_exits_2": code_empty == 2 and sorted(out["missing_empty"]) == sorted(stage_check.CHECKS),
                     "wrong_keys_exit_1": code_bad == 1 and out["failed_wrong_keys"] == ["unet"]}
    return out


def _tools_full_scale(seed: int) -> dict:
    """(c) the reference's default UNet on a 64x64 latent, the SD-1.5 VAE at
    ``TOOLS_VAE_SIZE`` and the 5-step compat loop on a ``TOOLS_LOOP_LATENT``
    latent, card vs CPU within the tool's bars, and the default UNet's bf16
    drift (recorded)."""
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.scripts import full_scale_parity as fsp

    out = {"unet_reference_config": fsp.unet_parity(presets.reference_unet_config(), seed, "cuda"),
           "vae_sd15": fsp.vae_parity(seed + 1, "cuda", TOOLS_VAE_SIZE),
           "sampling_loop": fsp.loop_parity(seed, "cuda", TOOLS_LOOP_LATENT)}
    out["checks"] = {"unet": out["unet_reference_config"]["ok"], "vae_encode": out["vae_sd15"]["encode"]["ok"],
                     "vae_decode": out["vae_sd15"]["decode"]["ok"], "loop": out["sampling_loop"]["ok"]}
    return out


def _tools_fid_eval(seed: int) -> dict:
    """(d) fid_eval at ``FID_RUN`` with the random-Inception ensemble: the
    compat sets apart from the default one by more than ``FID_ORDER`` times
    their own floor, in latent and in image features."""
    from stable_diffusion_pytorch_tpu_torch.scripts import fid_eval

    t0 = time.perf_counter()
    stack = fid_eval.Stack.seeded(seed, "cuda")
    r = fid_eval.run(stack, FID_RUN["n_images"], FID_RUN["steps"], FID_RUN["res"], FID_RUN["deep_cache"],
                     fid_eval.ImageFID("random_inception", stack, "cuda"), seed)
    r["seconds"] = time.perf_counter() - t0
    r["checks"] = {
        "latent_order": r["fid_latent_compat_vs_default"] > FID_ORDER * abs(r["fid_latent_compat_vs_compat"]),
        "image_order": r["fid_compat_vs_default"] > FID_ORDER * abs(r["fid_compat_vs_compat"]),
        "deep_cache_finite": r["fid_latent_exact_vs_dc3"] is not None}
    return r


def _tools_fid_samplers(seed: int) -> dict:
    """(e) fid_samplers cut to ``FS_RUN``: the quick-train's loss falls
    (last tenth below the first), DDIM's RMSE to the target falls with steps."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig
    from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
    from stable_diffusion_pytorch_tpu_torch.scripts import fid_samplers as fs

    t0 = time.perf_counter()
    schedule = make_schedule(DDPMConfig(noise_steps=1000))
    basis = fs.make_basis(FS_RUN["res"])
    unet = fs.build_unet(seed, "cuda")
    losses = fs.quick_train(unet, schedule, basis, FS_RUN["train_steps"])
    ctx_bank = fs.make_batch(basis, torch.Generator().manual_seed(1234), FS_RUN["n"])[1].numpy()
    r = {"cuts": {k: v for k, v in FS_RUN.items() if k in ("n", "train_steps", "target_steps", "grid")},
         "train_loss_first": losses[0], "train_loss_last": losses[-1],
         **fs.curve(unet, schedule, fs.parse_grid(FS_RUN["grid"]), ctx_bank, FS_RUN["n"], FS_RUN["res"],
                    FS_RUN["target_steps"], FS_RUN["guidance"], FS_RUN["pool"]),
         "seconds": time.perf_counter() - t0}
    tenth = max(1, len(losses) // 10)
    ddim = [row["rmse_latent_vs_target"] for row in r["curve"] if row["sampler"] == FS_DDIM[0]]
    r["checks"] = {"loss_falls": sum(losses[-tenth:]) < sum(losses[:tenth]),
                   "ddim_rmse_falls": len(ddim) == len(FS_DDIM[1]) and all(a > b for a, b in zip(ddim, ddim[1:]))}
    return r


def _tools_export_convert(stage: str, work: str) -> dict:
    """(f) export_torch of a checkpoint holding the staged SD-1.5 UNet (phase
    9e's weights), reloaded ``strict=True``: every tensor bit-equal;
    convert_inception of the staged ``.pth``: the ``.npz`` loads through
    ``load_inception_state`` bit-equal to the ``.pth`` path."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.models.build import without_default_init
    from stable_diffusion_pytorch_tpu_torch.models.inception import (
        convert_torchvision_inception,
        load_inception_state,
    )
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
    from stable_diffusion_pytorch_tpu_torch.scripts import convert_inception, export_torch
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import (
        load_reference_checkpoint,
        read_weights,
        save_checkpoint,
    )

    t0 = time.perf_counter()
    staged = load_reference_checkpoint(os.path.join(stage, "unet.pt"))
    save_checkpoint(os.path.join(work, "ckpt", "checkpoint-0"),
                    {"step": 0, "params": staged, "opt_state": {}, "ema_params": None})
    out_pt = os.path.join(work, "unet_export.pt")
    line = export_torch.main(["--checkpoint", os.path.join(work, "ckpt"), "--export-model", "unet", "--output", out_pt,
                              "--device", "cuda", *SD15_FLAGS])
    with without_default_init():
        unet = UNetModel(4, 32, presets.sd15_unet_config())
    unet.load_state_dict(torch.load(out_pt, weights_only=True), strict=True)
    differ = [k for k, v in unet.state_dict().items() if not torch.equal(v, staged[k])]
    del unet, staged
    npz = os.path.join(work, "converted", "inception", "inception_v3.npz")
    conv = convert_inception.main([os.path.join(stage, "inception", "inception_v3.pth"), npz])
    from_npz = load_inception_state(os.path.join(work, "converted"))
    from_pth = convert_torchvision_inception(read_weights(os.path.join(stage, "inception", "inception_v3.pth")))
    inception_differ = sorted(set(from_npz) ^ set(from_pth)) + [k for k in from_pth if k in from_npz and not
                                                                 torch.equal(from_npz[k], from_pth[k])]
    return {"export": line, "export_tensors_differ": differ[:5], "convert": conv,
            "inception_tensors_differ": inception_differ[:5], "seconds": time.perf_counter() - t0,
            "checks": {"export_bit_equal": not differ and line["exported"] > 0,
                       "convert_bit_equal": not inception_differ and conv["arrays"] > 0}}


def _tools_presets(work: str) -> dict:
    """(g) ``--config-file zero2.json`` found by name: the UNet trainer at
    SD-1.5 width, 256x256, batch 4, takes one optimizer step (4 micro steps);
    ``perf.json`` raises ``NotImplementedError`` naming item 20."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    t0 = time.perf_counter()
    trainer = build_sd15_trainer(os.path.join(work, "zero2"), PREPROCESS_SIZE, TRAIN_BATCH,
                                 ("--config-file", "zero2.json", "--max-train-steps", "1"))
    cfg = trainer.cfg
    before = [p.detach().clone() for p in trainer.state.params[:4]]
    trainer.train()
    moved = any(not torch.equal(a, b) for a, b in zip(before, trainer.state.params[:4]))
    with open(trainer.tracker.jsonl_path) as f:
        losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in line]
    res = {"zero2": {"gradient_accumulation_steps": cfg.train.gradient_accumulation_steps,
                     "shard_optimizer_state": cfg.parallel.shard_optimizer_state,
                     "max_grad_norm": cfg.optim.max_grad_norm, "optimizer_steps": trainer.state.optimizer.count,
                     "params_moved": moved, "losses": losses}}
    del trainer, before
    free_cuda()
    try:
        build_trainer(train_argv(os.path.join(work, "perf"), *TINY_FLAGS, "--config-file", "perf.json"))
        res["perf_error"] = None
    except NotImplementedError as exc:  # the expected refusal
        res["perf_error"] = str(exc)
    res["seconds"] = time.perf_counter() - t0
    z = res["zero2"]
    res["checks"] = {"zero2_fields": (z["gradient_accumulation_steps"], z["shard_optimizer_state"],
                                      z["max_grad_norm"]) == (4, True, 1.0),
                     "zero2_step": z["optimizer_steps"] == 1 and z["params_moved"] and len(z["losses"]) == 1
                     and all(math.isfinite(v) for v in z["losses"]),
                     "perf_names_item_20": bool(res["perf_error"]) and "item 20" in res["perf_error"]}
    return res


def phase_tools(stage: str, work: str) -> dict:
    """Phase 9g: the evaluation and interop tools on the card, (a)-(g) of
    ``_tools_*``, each with its checks; the launches of every run, then each
    kernel held against its plain version at every launch shape phase 2 did
    not hold (``hold_shape``, no timings)."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    native.reset_counters()
    runs = {}
    for name, fn, args in (("stage_check", _tools_stage_check, (stage, os.path.join(work, "stage_check"))),
                           ("full_scale_parity", _tools_full_scale, (TOOLS_SEED,)),
                           ("fid_eval", _tools_fid_eval, (TOOLS_SEED,)),
                           ("fid_samplers", _tools_fid_samplers, (TOOLS_SEED,)),
                           ("export_convert", _tools_export_convert, (stage, work)),
                           ("presets", _tools_presets, (work,))):
        t1 = time.perf_counter()
        runs[name] = fn(*args)
        runs[name]["seconds"] = time.perf_counter() - t1
        free_cuda()
    torch.cuda.synchronize()
    launches = launch_counts()
    seen = {name: {(k[:-1], str(k[-1]).replace("torch.", "")) for k in native.COUNTERS[name].shapes}
            for name in TPU_KERNELS}
    failures = {k: [c for c, ok in r["checks"].items() if not ok] for k, r in runs.items()}
    failures = {k: v for k, v in failures.items() if v}
    out = {"phase": "tools", "gpu": gpu_line(), "runs": runs, "launches": launches,
           "run_seconds": time.perf_counter() - t0}
    emit({**out, "ok": not failures})
    check(not failures, f"tools checks failed: {failures}")
    return out, seen


def hold_new_shapes(seen: dict, held: dict) -> dict:
    """Every kernel at each (launch shape, dtype) of ``seen`` whose shape
    phase 2 did not hold (``held``), against its plain version
    (``hold_shape``); K3's on the split set too, as phase 2 holds them."""
    import torch

    new = {name: sorted(k for k in keys if k[0] not in {tuple(h) for h in held.get(name, [])})
           for name, keys in seen.items()}
    new["flash_attention_bwd_split"] = sorted(set(new["flash_attention_bwd_split"]) | set(new["flash_attention_bwd"]))
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, failures = [], []
    for name, keys in new.items():
        for key, dname in keys:
            row, ok = hold_shape(name, key, dname, gen)
            rows.append(row)
            if not ok:
                failures.append(row)
        torch.cuda.empty_cache()
    res = {"phase": "tools_kernels", "n_shapes": {k: len(v) for k, v in new.items()}, "failures": failures,
           "ok": not failures}
    emit(res)
    check(not failures, f"kernel disagrees with its plain version at a tools shape: {failures}")
    return {**res, "shapes": rows}


def _checkpoint_round_trip(work: str, flags) -> dict:
    """Train 2 steps saving checkpoint-2, resume ``latest`` in a new trainer
    and compare every tensor of the parameters, EMA and optimizer state."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

    shutil.rmtree(work, ignore_errors=True)
    flags = [*TINY_FLAGS, "--resolution", "64", "--train-batch-size", "2", "--eval-batch-size", "2",
             "--gradient-accumulation-steps", "2", "--max-train-steps", "2", "--checkpointing-steps", "2",
             "--lr-warmup-steps", "0", "--ema-decay", "0.9", "--max-train-samples", "8", "--max-val-samples", "2",
             "--log-interval", "0", "--dataloader-num-workers", "0", *flags]
    first = build_trainer(train_argv(work, *flags))
    first.train()
    path = os.path.join(work, "ckpt", "checkpoint-2")
    saved = load_checkpoint(path, map_location="cuda")
    second = build_trainer(train_argv(work, *flags, "--resume-from-checkpoint", "latest", "--seed", "1"))
    replay = second._resume()
    got = second.state.state_dict()
    mismatched = [f"{part}.{n}" for part in ("params", "ema_params")
                  for n, t in saved[part].items() if not torch.equal(got[part][n], t)]
    lists = sorted(k for k, v in saved["opt_state"].items() if isinstance(v, list))
    mismatched += [f"opt_state.{k}" for k in lists
                   if len(got["opt_state"][k]) != len(saved["opt_state"][k])
                   or not all(torch.equal(a, b) for a, b in zip(got["opt_state"][k], saved["opt_state"][k]))]
    live = first.state.state_dict()
    mismatched += [f"live.{n}" for n, t in live["params"].items() if not torch.equal(got["params"][n], t)]
    res = {"flags": list(flags[len(TINY_FLAGS):]), "path": os.path.relpath(path, REPO),
           "files": sorted(os.listdir(path)), "resumed_global_step": replay["global_step"], "step": got["step"],
           "count": got["opt_state"]["count"], "layout": got["opt_state"]["layout"], "optimizer_lists": lists,
           "n_tensors": len(saved["params"]), "mismatched": mismatched[:20]}
    res["ok"] = (not mismatched and replay["global_step"] == 2 and got["step"] == saved["step"] == 4
                 and got["opt_state"]["count"] == 2 and got["opt_state"]["layout"] == saved["opt_state"]["layout"])
    return res


# --------------------------------------------------------------------------- #
# phase 9f: multi-device training on the one card
# --------------------------------------------------------------------------- #


def parallel_argv(work: str, stage: str, flags=()):
    return train_argv(
        work, *SD15_FLAGS, "--model-dir", stage, "--resolution", "512", "--train-batch-size", str(TRAIN_BATCH),
        "--gradient-accumulation-steps", "1", "--max-train-steps", str(PARALLEL_STEPS), "--lr-warmup-steps", "0",
        "--learning-rate", str(PARALLEL_LR), "--max-train-samples", str(PARALLEL_STEPS * TRAIN_BATCH),
        "--log-interval", "0", "--dataloader-num-workers", "4", *flags)


def _whole_params(trainer) -> dict:
    """{name: the whole parameter} in the checkpoint layout (every rank gathers)."""
    return trainer.state.state_dict()["params"]


def _parallel_train(work: str, stage: str, flags, restore: bool = False) -> tuple:
    """Build the UNet trainer through the entry point (``build_trainer``,
    which joins the launcher's process group) from the staged weights, train
    ``PARALLEL_STEPS`` optimizer steps; under offload save a checkpoint
    after them (and with ``restore`` restore it) -> (record, the trainer,
    {name: initial parameter on the host} under FSDP, else None)."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.parallel.mesh import per_device_bytes
    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    shutil.rmtree(work, ignore_errors=True)
    allocated = torch.cuda.memory_allocated()
    trainer = build_trainer(parallel_argv(work, stage, flags))
    opt = trainer.state.optimizer
    start = _whole_params(trainer)
    checksums = _checksums(start)
    theta0 = {n: t.detach().to("cpu", copy=True) for n, t in start.items()} if opt.dp.fsdp else None
    del start
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counters()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(trainer.tracker.jsonl_path) as f:
        losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in line]
    timer = trainer.step_timer
    res = {
        "flags": list(flags), "world": trainer.world, "global_batch": trainer.global_train_batch,
        "allocated_before_build_gb": allocated / 2**30, "start_checksums": checksums,
        "train_loss": losses, "finite": all(math.isfinite(v) for v in losses), "optimizer_steps": opt.count,
        "launches": launches, "timed_steps": len(timer.durations), "step_ms_p50": timer.percentile(50) * 1e3,
        "step_ms_min": min(timer.durations) * 1e3, "step_ms_max": max(timer.durations) * 1e3,
        "samples_per_s": trainer.global_train_batch / timer.percentile(50), "total_s": total_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "optimizer": type(opt).__name__, "optimizer_state_bytes": opt.state_bytes(),
        "optimizer_state_bytes_on_card": per_device_bytes(opt.state_tensors(), trainer.device),
        "offload": opt.offload, "host_transfer_s_per_step": opt.transfer_s / max(opt.count, 1),
        "offload_groups": len(opt._offload_groups()) if opt.offload else None,
        "fsdp": opt.dp.fsdp, "zero_sharded_leaves": sum(d is not None for d in opt.dp.dims),
    }
    if opt.offload:  # a checkpoint gathers the state: it must not bring the moments back to the card
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        path = trainer.ckpt_manager.save(opt.count, trainer.state, write=trainer.is_main_process)
        torch.cuda.synchronize()
        res["save_s"] = time.perf_counter() - t1
        res["save_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - before
        res["peak_mem_with_save_gb"] = max(res["peak_mem_gb"], torch.cuda.max_memory_allocated() / 2**30)
        res["largest_leaf_moment_bytes"] = max(opt.leaf_moment_bytes(i) for i in range(len(opt.params)))
        res["checkpoint_gb"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9
        if restore:  # and restoring it (the state the run goes on to compare) must not either
            trainer.ckpt_manager.resume_from = path
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            res["restored"] = trainer.ckpt_manager.restore(trainer.state)[0]
            torch.cuda.synchronize()
            res["restore_s"] = time.perf_counter() - t1
            res["restore_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - before
        shutil.rmtree(path)
    return res, trainer, theta0


def _checksums(params: dict, device="cuda") -> dict:
    """{name: a checksum of the f32 tensor's bits in logical order}: each
    32-bit word times (its index mod 251) + 1, summed in int64 (no overflow
    below 2^24 elements a leaf), exact whatever the memory layout or the
    order of the sum; the runs' initial weights compared."""
    import torch

    sums = []
    for t in params.values():
        words = t.detach().to(device).contiguous().view(-1).view(torch.int32).to(torch.int64)
        sums.append((words * (torch.arange(words.numel(), device=words.device) % 251 + 1)).sum())
    return dict(zip(params, torch.stack(sums).tolist()))


def compare_params(params: dict, base: dict, theta0: dict = None) -> dict:
    """A run's final parameters against the one-process run's, ``base``, in
    one pass over the leaves: the largest absolute gap and whether every
    leaf is equal bit for bit; with the initial parameters ``theta0`` also
    the update gap: the update applied, d = params - theta0, against the
    baseline's, d_b = base - theta0, as ||d - d_b|| / ||d_b|| over all
    leaves (``global``), of the median leaf and of the worst; the same for
    each ``PARALLEL_CONTROLS`` path, whose update is ``s * d`` (from each
    leaf's ||d||^2, ||d_b||^2 and <d, d_b>, in float64)."""
    import torch

    rows = []
    for n, p in params.items():
        p, b = p.detach(), base[n].to(p.device)
        row = [(p.float() - b.float()).abs().max().double(), (p != b).any().double()]
        if theta0 is not None:
            t0 = theta0[n].to(p.device)
            d, db = (p.float() - t0).double(), (b.float() - t0).double()
            row += [(d * d).sum(), (db * db).sum(), (d * db).sum(), ((d - db) ** 2).sum()]
        rows.append(torch.stack(row))
    rows = torch.stack(rows).tolist()  # one wait for the whole pass
    out = {"max_abs_param_gap": max(r[0] for r in rows), "params_bitwise_equal": not any(r[1] for r in rows)}
    if theta0 is None:
        return out
    scales = {"run": 1.0, **PARALLEL_CONTROLS}
    per = {k: [] for k in scales}
    tot = {k: 0.0 for k in scales}
    tot_b = 0.0
    for _, _, dd, bb, cross, diff in rows:
        tot_b += bb
        for k, sc in scales.items():
            sq = diff if k == "run" else max(sc * sc * dd - 2.0 * sc * cross + bb, 0.0)
            tot[k] += sq
            per[k].append(math.sqrt(sq / bb) if bb > 0 else (0.0 if sq == 0 else math.inf))
    gaps = {k: {"global": math.sqrt(tot[k] / tot_b) if tot_b > 0 else math.inf,
                "median_leaf": statistics.median(per[k]), "worst_leaf": max(per[k])} for k in scales}
    return {**out, "update_gap": gaps.pop("run"), "update_gap_controls": gaps}


def update_ok(gap: dict) -> bool:
    return all(gap[k] <= tol for k, tol in PARALLEL_UPDATE_TOL.items())


def parallel_child(spec_path: str) -> int:
    """The one rank of phase 9f's runs (started by ``torchrun`` from the
    phase): for each run the spec lists, train, compare with the
    one-process baseline it names, write the record where it says."""
    import torch
    import torch.distributed as dist

    with open(spec_path) as f:
        specs = json.load(f)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    torch.backends.cudnn.deterministic = True
    from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update, flash_attention, fused_groupnorm  # noqa: F401

    for spec in specs:
        res, trainer, theta0 = _parallel_train(spec["work"], spec["stage"], spec["flags"], spec["restore"])
        res["backend"] = dist.get_backend() if dist.is_initialized() else None
        base = torch.load(spec["baseline"], map_location="cuda", weights_only=True)  # the run's peak is read
        res["same_start"] = res.pop("start_checksums") == base["start_checksums"]
        res.update(compare_params(_whole_params(trainer), base["params"], theta0))
        res["loss_rel_gap"] = [abs(a - b) / abs(b) for a, b in zip(res["train_loss"], base["train_loss"])]
        res["losses_equal"] = res["train_loss"] == base["train_loss"]
        with open(spec["result"], "w") as f:
            json.dump(res, f)
        del trainer, theta0, base
        free_cuda()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _run_group(cmd, timeout: float) -> int:
    """Run ``cmd`` in a session of its own; past ``timeout`` kill the session
    (the launcher and its ranks) and fail."""
    import signal

    proc = subprocess.Popen(cmd, start_new_session=True, env={**os.environ, "PYTHONPATH": REPO})
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SmokeFailure(f"{' '.join(cmd[:6])} ... ran past {timeout} s")


PIECES = ("params", "codes", "scales", "codes", "scales")  # a leaf's parameter, mu (codes, scales), nu (the same)


def _int8_state_bytes(shape) -> int:
    """Bytes of one leaf's int8 moments: two sets of codes (1 B an element)
    and f32 scales (one per block and column)."""
    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import blocked_layout

    _, r, _, nb = blocked_layout(shape, 256)
    return 2 * (math.prod(shape) + 4 * nb * r)


def _k9_pieces(tensors, dim, rank: int, n: int, fmt):
    """Rank ``rank``'s copies of ``tensors`` cut ``n`` ways along ``dim``
    (whole copies for None): always copies, since K9 writes its leaves in
    place (a one-block leaf's scale slice is a contiguous view of the whole)."""
    if dim is None:
        return [t.clone() for t in tensors]
    return [t.narrow(dim, rank * (t.shape[dim] // n), t.shape[dim] // n).clone(memory_format=fmt)
            for t in tensors]


def parallel_k9_record(leaf_shapes) -> dict:
    """(b) K9 per ZeRO shard: the SD-1.5 UNet's 686 leaves cut by the port's
    rule (``int8_shard_dim``) for 2, 4 and 8 ranks; for each simulated rank
    one K9 launch over its slices and its whole leaves (bf16 gradients, the
    clip active at half the global norm, which the ranks share); the slices
    put back together and every rank's whole leaves must equal one launch
    over the whole leaves, bit for bit (parameters, codes, scales)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import LAUNCHES, Adam8bitStep, memory_format
    from stable_diffusion_pytorch_tpu_torch.parallel.mesh import local_shape, zero_dims
    from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm

    shapes, params, grads, mu, nu = sd15_leaves(leaf_shapes, seed=9)
    g = grads["bfloat16"]
    del grads
    norm = global_norm(g)
    limit = 0.5 * float(norm)
    bc1, bc2 = (float(torch.tensor(b, dtype=torch.float32)) for b in ADAM_BC)
    lr, wd = float(torch.tensor(1e-4, dtype=torch.float32)), 0.1
    args = (norm, bc1, bc2, lr, 0.9, 0.999, 1e-8, wd, limit)
    whole = _state_copy(params, mu, nu)
    Adam8bitStep(*whole, 256)(g, *args)
    torch.cuda.synchronize()
    worlds = {}
    for n in PARALLEL_K9_WORLDS:
        dims = zero_dims(shapes, n, int8_block=256)
        put = _state_copy(params, mu, nu)
        ms, launches, differ = [], 0, {"params": 0, "codes": 0, "scales": 0}
        for rank in range(n):
            local = [[], [], [], []]  # params, grads, mu, nu
            for p, gr, m, v, d in zip(params, g, mu, nu, dims):
                fmt = memory_format(p)
                (lp, lg), lm, lv = (_k9_pieces((p, gr), d, rank, n, fmt), tuple(_k9_pieces(m, d, rank, n, fmt)),
                                    tuple(_k9_pieces(v, d, rank, n, fmt)))
                for dst, x in zip(local, (lp, lg, lm, lv)):
                    dst.append(x)
            step = Adam8bitStep(local[0], local[2], local[3], 256)
            before = LAUNCHES.count
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(local[1], *args)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
            launches += LAUNCHES.count - before
            for i, d in enumerate(dims):
                got = [local[0][i], *local[2][i], *local[3][i]]
                want = [whole[0][i], *whole[1][i], *whole[2][i]]
                if d is None:  # a whole leaf: every rank must give the one-launch result
                    for name, a, b in zip(PIECES, got, want):
                        differ[name] += not torch.equal(a, b)
                    continue
                dst = [put[0][i], *put[1][i], *put[2][i]]
                for a, b in zip(dst, got):
                    a.narrow(d, rank * b.shape[d], b.shape[d]).copy_(b)
            del local, step
        for i, d in enumerate(dims):
            if d is not None:
                for name, a, b in zip(PIECES, [put[0][i], *put[1][i], *put[2][i]],
                                      [whole[0][i], *whole[1][i], *whole[2][i]]):
                    differ[name] += not torch.equal(a, b)
        worlds[n] = {"ranks": n, "sharded_leaves": sum(d is not None for d in dims),
                     "whole_leaves": sum(d is None for d in dims), "launches": launches,
                     "launches_per_rank": launches / n, "ms_per_rank": ms,
                     "state_bytes_per_rank": sum(_int8_state_bytes(local_shape(s, d, n)) for s, d in zip(shapes, dims)),
                     "leaves_differ": differ, "ok": launches == n and not any(differ.values())}
        del put
        free_cuda()
    whole_bytes = sum(_int8_state_bytes(s) for s in shapes)
    del params, g, mu, nu, whole
    free_cuda()
    return {"n_leaves": len(shapes), "state_bytes_whole": whole_bytes, "worlds": worlds,
            "ok": all(w["ok"] for w in worlds.values())}


def parallel_runs(work: str, stage: str) -> dict:
    """9f (a): one process with no flag from the staged weights (f32 AdamW,
    and int8 Adam for the int8 runs), then one subprocess under ``torchrun
    --nproc_per_node 1`` over NCCL that runs the UNet entry point once per
    ``PARALLEL_RUNS`` configuration and compares each with its baseline ->
    {"baselines", "runs"}."""
    import torch

    os.makedirs(work, exist_ok=True)
    baselines = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the baselines and the ranks pick the same conv algorithms
    try:
        for kind, flags in (("f32", ()), ("int8", ("--use-8bit-adam",))):
            res, trainer, _ = _parallel_train(os.path.join(work, f"baseline_{kind}"), stage, flags)
            path = os.path.join(work, f"baseline_{kind}.pt")
            torch.save({"params": {n: t.detach().cpu() for n, t in _whole_params(trainer).items()},
                        "start_checksums": res["start_checksums"], "train_loss": res["train_loss"]}, path)
            baselines[kind] = {**res, "path": path}
            del trainer
            free_cuda()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    specs = []
    for name, flags in PARALLEL_RUNS:
        kind = "int8" if "--use-8bit-adam" in flags else "f32"
        specs.append({"name": name, "kind": kind, "work": os.path.join(work, name), "stage": stage,
                      "flags": list(flags), "restore": name in PARALLEL_RESTORE,
                      "baseline": baselines[kind]["path"], "result": os.path.join(work, f"{name}.json")})
        if os.path.exists(specs[-1]["result"]):
            os.remove(specs[-1]["result"])
    spec_path = os.path.join(work, "runs_spec.json")
    with open(spec_path, "w") as f:
        json.dump(specs, f)
    rc = _run_group([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                     os.path.abspath(__file__), "--parallel-child", spec_path], PARALLEL_RUNS_TIMEOUT_S)
    runs = {}
    for spec in specs:
        name, kind = spec["name"], spec["kind"]
        check(os.path.exists(spec["result"]), f"9f run {name} failed (the runs' exit code {rc})")
        with open(spec["result"]) as f:
            r = json.load(f)
        base = baselines[kind]
        required = TRAIN_KERNELS + (("adam8bit_update",) if kind == "int8" else ())
        r["baseline_peak_mem_gb"] = base["peak_mem_gb"]
        r["baseline_optimizer_state_bytes_on_card"] = base["optimizer_state_bytes_on_card"]
        r["peak_mem_drop_gb"] = base["peak_mem_gb"] - r["peak_mem_gb"]
        r["step_ms_p50_vs_baseline"] = r["step_ms_p50"] - base["step_ms_p50"]
        # K9: one launch per optimizer step, or per group of leaves whose moments come in together (offload)
        k9_want = PARALLEL_STEPS * (r["offload_groups"] or 1) if kind == "int8" else 0
        ok = (r["backend"] == "nccl" and r["world"] == 1 and r["finite"] and r["same_start"]
              and len(r["train_loss"]) == PARALLEL_STEPS and r["optimizer_steps"] == PARALLEL_STEPS
              and all(r["launches"][k] > 0 for k in required) and r["launches"]["adam8bit_update"] == k9_want)
        if r["fsdp"]:
            r["controls_fail"] = {k: not update_ok(g) for k, g in r["update_gap_controls"].items()}
            ok = (ok and update_ok(r["update_gap"]) and all(r["controls_fail"].values())
                  and max(r["loss_rel_gap"]) <= PARALLEL_LOSS_TOL)
        else:  # world 1: every collective is a copy, the same kernels run on the same data
            ok = ok and r["params_bitwise_equal"] and r["losses_equal"]
        if r["offload"]:
            extra = max(r["save_peak_extra_bytes"], r.get("restore_peak_extra_bytes", 0))
            ok = ok and (r["optimizer_state_bytes_on_card"] <= 0.01 * base["optimizer_state_bytes_on_card"]
                         and r.get("restored", not spec["restore"]) and extra <= r["largest_leaf_moment_bytes"])
        r["ok"] = ok
        runs[name] = r
        emit({"phase": f"parallel_{name}", "gpu": gpu_line(), **{k: v for k, v in r.items() if k != "launches"}})
        check(ok, f"9f run {name} failed its checks: {r}")
    check(rc == 0, f"9f runs exited {rc}")
    return {"baselines": baselines, "runs": runs}


def phase_parallel(work: str, stage: str, leaf_shapes) -> dict:
    """9f: (a) :func:`parallel_runs`; (b) K9 per ZeRO shard for 2, 4 and 8 ranks."""
    res = {"phase": "parallel", "gpu": gpu_line(), "steps": PARALLEL_STEPS, **parallel_runs(work, stage)}
    k9 = parallel_k9_record(leaf_shapes)
    res["k9_per_shard"] = k9
    res["ok"] = k9["ok"] and all(r["ok"] for r in res["runs"].values())
    emit({"phase": "parallel_k9", "gpu": res["gpu"], **k9})
    check(k9["ok"], f"K9 per shard differs from K9 over whole leaves: {k9}")
    check(res["ok"], "parallel phase failed")
    return res


def phase_checkpoint(work: str) -> dict:
    """Small width on the card, the f32 optimizer and the lean one (int8 Adam,
    bf16 accumulator): each saves checkpoint-2 and is resumed exactly."""
    runs = {"f32": _checkpoint_round_trip(work, ()),
            "lean": _checkpoint_round_trip(work + "_lean", ("--use-8bit-adam", "--accum-dtype", "bf16"))}
    res = {"phase": "checkpoint", "runs": runs, "ok": all(r["ok"] for r in runs.values())}
    emit(res)
    check(res["ok"], f"checkpoint round trip failed: {res}")
    check("mu_q" in runs["lean"]["optimizer_lists"], f"the lean checkpoint holds no int8 codes: {runs['lean']}")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write every phase's JSON to DIR/chip_smoke.json")
    parser.add_argument("--parallel-child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "stable_diffusion_pytorch_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    if args.parallel_child:
        return parallel_child(args.parallel_child)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    work = os.path.join(REPO, "build", "chip_smoke_train")

    seconds = {}

    def timed(name: str, fn, *args):
        """``fn(*args)``, its wall seconds printed on a line of their own."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name]})
        return out

    t_start = time.perf_counter()
    env = timed("env", phase_env)
    staged = timed("stage", stage_pretrained, os.path.join(REPO, "build", "chip_smoke_pretrained"))
    env["staged"] = staged
    emit({"phase": "stage", **staged})
    model = build_sd15("cuda", torch.bfloat16, SEED)
    shapes, leaf_shapes, lora_leaf_shapes = timed("probes", record_shapes, model, work, staged["root"])
    kernels = timed("kernels", phase_kernels, shapes, leaf_shapes, lora_leaf_shapes)
    correlated = timed("correlated", phase_correlated, kernels)
    optimizer = timed("optimizer", phase_optimizer, leaf_shapes, kernels)
    parity = timed("unet_parity", phase_unet_parity, SEED)
    train_parity = timed("train_parity", phase_train_parity, SEED)
    vae_parity = timed("vae_train_parity", phase_vae_train_parity, SEED)
    slice_res = timed("slice", phase_slice, model, STEPS, NUM_IMAGES)
    hires_res = timed("hires", phase_hires, model, STEPS)
    samplers_res = timed("samplers", phase_samplers, model, STEPS)
    features_res = timed("features", phase_features, model, STEPS, os.path.join(REPO, "build", "chip_smoke_features"))
    del model
    free_cuda()
    serve_res = timed("serve", phase_serve, os.path.join(REPO, "build", "chip_smoke_serve"), STEPS)
    free_cuda()
    trains = {}
    for name, size, batch, flags, required in TRAIN_PHASES:
        t0 = time.perf_counter()
        trainer = build_sd15_trainer(f"{work}_{name}", size, batch, flags)
        trains[name] = phase_train(trainer, name, size, batch, required, free_cuda())
        del trainer
        free_cuda()
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name]})
    t0 = time.perf_counter()
    trainer = build_sd15_vae_trainer(f"{work}_vae_train", VAE_TRAIN, VAE_TRAIN_BATCH)
    trains["vae_train"] = phase_train(trainer, "vae_train", VAE_TRAIN, VAE_TRAIN_BATCH, VAE_TRAIN_KERNELS,
                                      free_cuda())
    del trainer
    free_cuda()
    seconds["vae_train"] = time.perf_counter() - t0
    emit({"phase": "vae_train", "seconds": seconds["vae_train"]})
    personalize = timed("personalize", phase_personalize, os.path.join(REPO, "build", "chip_smoke_personalize"))
    free_cuda()
    options = timed("train_options", phase_train_options, os.path.join(REPO, "build", "chip_smoke_options"),
                    trains["train"])
    free_cuda()
    eval_res = timed("eval", phase_eval, staged["root"], os.path.join(REPO, "build", "chip_smoke_eval"))
    free_cuda()
    tools, tools_seen = timed("tools", phase_tools, staged["root"], os.path.join(REPO, "build", "chip_smoke_tools"))
    free_cuda()
    tools_kernels = timed("tools_kernels", hold_new_shapes, tools_seen, shapes)
    free_cuda()
    parallel = timed("parallel", phase_parallel, os.path.join(REPO, "build", "chip_smoke_parallel"), staged["root"],
                     leaf_shapes)
    free_cuda()
    ckpt = timed("checkpoint", phase_checkpoint, os.path.join(REPO, "build", "chip_smoke_ckpt"))
    seconds["total"] = time.perf_counter() - t_start

    main_path = [slice_res["launches"], *(r["launches"] for r in hires_res["runs"].values()),
                 *(r["launches"] for r in samplers_res["runs"].values()),
                 *(r["launches"] for r in features_res["runs"].values()), serve_res["launches"],
                 *(r["launches"] for r in trains.values()), *(r["launches"] for r in personalize["runs"].values()),
                 *(r["launches"] for r in options["runs"].values()),
                 *(eval_res["runs"][k]["launches"] for k in ("txt2img", "clip_score")), tools["launches"],
                 *(r["launches"] for r in parallel["baselines"].values()),
                 *(r["launches"] for r in parallel["runs"].values())]
    summary = []
    for name, (route, source, replaces) in TPU_KERNELS.items():
        s = kernels["summary"][name]
        summary.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches[name] for launches in main_path),
            "max_abs_err": s["max_abs_err_bf16"], "ms": s["ms_bf16"], "plain_ms": s["plain_ms_bf16"],
            "bound_ms": s["bound_ms_bf16"],
            "bound_by": "operations" if s["ops_bound_ms_bf16"] >= s["bytes_bound_ms_bf16"] else "bytes",
            "library_ms": s["library_ms_bf16"], "impl": s["impl"] or None,
        })
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"env": env, "shapes": shapes, "leaf_shapes": sorted((list(k), n) for k, n in leaf_shapes.items()),
                       "lora_leaf_shapes": sorted((list(k), n) for k, n in lora_leaf_shapes.items()),
                       "kernels": kernels, "correlated": correlated, "optimizer": optimizer,
                       "unet_parity": parity,
                       "flash_attention_launches_kv_past_9216": sum(
                           launches["flash_attention_kv_past_9216"] for launches in main_path),
                       "train_parity": train_parity, "vae_train_parity": vae_parity, "slice": slice_res,
                       "hires": hires_res, "samplers": samplers_res, "features": features_res,
                       "serve": serve_res, **trains, "personalize": personalize, "train_options": options,
                       "eval": eval_res, "tools": tools, "tools_kernels": tools_kernels, "parallel": parallel,
                       "checkpoint": ckpt, "seconds": seconds, "summary": summary}, f, indent=1)
    emit({"phase": "total", "seconds": seconds["total"]})
    print(env["gpu"], flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
