"""Trainer / optimizer / logging / checkpoint configuration dataclasses.

Copies of the JAX package's ``trainers/args.py`` dataclasses: the same field
names, defaults and help strings (a test pins them equal), so one launch
command drives either trainer. Options whose feature the port has not taken
over raise ``NotImplementedError`` in the trainer. The deprecated legacy
argparse helpers are not copied.
"""

from dataclasses import dataclass, field
from typing import Optional

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig


@dataclass
class LogConfig(BaseConfig):
    logging_dir: str = field(default="logs", metadata={"help": "log directory"})
    with_tracking: bool = field(
        default=False, metadata={"help": "whether enable tracker"}
    )
    report_to: str = field(
        default="wandb",
        metadata={"help": "tracker to use, only enabled when passed in --with_tracker"},
    )
    resume: bool = field(
        default=False, metadata={"help": "whether resume from latest run"}
    )
    log_image: bool = field(
        default=False, metadata={"help": "whether test image gen at each evaluation"}
    )
    test_image: str = field(
        default="data/test_images/test01.png",
        metadata={"help": "test image path for log_image"},
    )
    log_grad_noise_scale: bool = field(
        default=False,
        metadata={
            "help": "estimate the gradient noise scale (McCandlish et al. 2018) "
            "from half-batch gradients each step (same FLOPs) and log the "
            "EMA-smoothed B_noise — the batch size beyond which scaling stops "
            "paying off. Observability extension beyond the reference."
        },
    )
    spike_threshold: float = field(
        default=0.0,
        metadata={
            "help": "flag a train-loss spike when loss exceeds the running mean "
            "by this many running std-devs (0 disables); spikes emit a WARNING "
            "and a loss_spike field in the metrics stream."
        },
    )


@dataclass
class TrainConfig(BaseConfig):
    seed: int = field(default=42, metadata={"help": "seed argument"})
    max_train_steps: int = field(
        default=20000,
        metadata={"help": "total train steps, if provided, overrides max_train_epochs"},
    )
    max_train_epochs: int = field(default=100, metadata={"help": "max train epochs"})
    train_batch_size: int = field(
        default=8, metadata={"help": "train batch size per processor"}
    )
    eval_batch_size: int = field(
        default=8, metadata={"help": "eval batch size per processor"}
    )
    log_interval: int = field(
        default=100,
        metadata={
            "help": "do evaluation every n steps, default 0 means no evaluation during training"
        },
    )
    gradient_accumulation_steps: int = field(
        default=4, metadata={"help": "gradient accumulation steps"}
    )
    steps_per_dispatch: int = field(
        default=1,
        metadata={
            "help": "optimizer steps chained into one XLA program via lax.scan "
            "(TPU-only win: amortizes the runtime's per-dispatch and "
            "host-sync overhead; no reference analog — torch launches one "
            "step per Python iteration). Chunks break automatically at "
            "checkpoint/eval/termination boundaries; 1 = dispatch per step."
        },
    )
    use_deepspeed: bool = field(
        default=False,
        metadata={
            "help": "accepted for CLI parity with the reference; optimizer-state "
            "sharding on TPU is --shard-optimizer-state instead"
        },
    )
    guidance_scale: float = field(
        default=7.5, metadata={"help": "guidance scale for classifier free guidance"}
    )
    ema_decay: float = field(
        default=0.0,
        metadata={
            "help": "EMA decay for shadow model weights (0 disables; standard SD "
            "practice is 0.9999). EMA params are saved in checkpoints."
        },
    )
    prediction_type: str = field(
        default="epsilon",
        metadata={
            "help": "training objective: epsilon (reference behavior) or "
            "v_prediction (SD-2.x-style, Salimans & Ho 2022). Sampling from a "
            "v-trained checkpoint needs the matching --prediction-type.",
            "choices": ["epsilon", "v_prediction"],
        },
    )
    snr_gamma: float = field(
        default=0.0,
        metadata={
            "help": "Min-SNR-gamma loss weighting (Hang et al. 2023); 0 "
            "disables, 5.0 is the paper's recommendation."
        },
    )
    noise_offset: float = field(
        default=0.0,
        metadata={
            "help": "offset-noise strength: add offset*N(0,1) per (example, "
            "channel) to the training noise so the model learns to shift "
            "global brightness (0.05-0.1 typical; 0 disables)."
        },
    )
    input_perturbation: float = field(
        default=0.0,
        metadata={
            "help": "input perturbation gamma (Ning et al. 2023): q-sample "
            "with noise + gamma*N(0,1) while regressing the unperturbed "
            "noise — a training-only regularizer against sampling drift "
            "(0.1 typical; 0 disables)."
        },
    )
    lora_rank: int = field(
        default=0,
        metadata={
            "help": "LoRA rank r: freeze the UNet and train only rank-r "
            "factors on the attention projections (0 disables; 4-64 typical). "
            "Checkpoints then contain ONLY the LoRA tree."
        },
    )
    lora_alpha: float = field(
        default=0.0,
        metadata={
            "help": "LoRA alpha; the merged update is (alpha/rank)*A@B. "
            "0 means alpha=rank (scale 1.0)."
        },
    )
    lora_targets: str = field(
        default="attn",
        metadata={
            "help": "which kernels take LoRA factors.",
            "choices": ["attn", "attn_mlp"],
        },
    )
    placeholder_token: str = field(
        default="<concept>",
        metadata={
            "help": "textual-inversion placeholder string; its occurrences in "
            "prompts tokenize to the learned embedding slots "
            "(train_textual_inversion.py only)."
        },
    )
    num_vectors: int = field(
        default=1,
        metadata={
            "help": "number of learned embedding vectors the placeholder "
            "expands to (textual inversion)."
        },
    )
    initializer_token: str = field(
        default="",
        metadata={
            "help": "word whose embedding initializes the learned vectors "
            "(textual inversion); empty = small random init."
        },
    )
    cfg_dropout_prob: float = field(
        default=0.1,
        metadata={
            "help": "probability of swapping a prompt for the empty prompt "
            "during UNet training (classifier-free-guidance dropout; the "
            "reference hardcodes 0.1, train_unet.py:518-521)."
        },
    )
    instance_data_dir: str = field(
        default="",
        metadata={
            "help": "folder of subject images for DreamBooth "
            "(train_dreambooth.py only)."
        },
    )
    instance_prompt: str = field(
        default="a photo of sks subject",
        metadata={
            "help": "prompt with the rare identifier describing the DreamBooth "
            "subject, e.g. 'a photo of sks dog'."
        },
    )
    with_prior_preservation: bool = field(
        default=False,
        metadata={
            "help": "DreamBooth: add the class-prior preservation loss "
            "(Ruiz et al. 2022) using generated class images."
        },
    )
    class_data_dir: str = field(
        default="",
        metadata={
            "help": "folder of class images for prior preservation; missing "
            "images are generated by the current model before training."
        },
    )
    class_prompt: str = field(
        default="a photo of a subject",
        metadata={
            "help": "class prompt (no identifier) used to generate and train "
            "on prior-preservation images."
        },
    )
    num_class_images: int = field(
        default=16,
        metadata={
            "help": "how many class images prior preservation uses (generated "
            "into --class-data-dir if fewer are present)."
        },
    )
    prior_loss_weight: float = field(
        default=1.0,
        metadata={"help": "weight of the prior-preservation loss term."},
    )
    class_sampling_steps: int = field(
        default=50,
        metadata={
            "help": "DDIM steps used when generating missing class images."
        },
    )


@dataclass
class OptimConfig(BaseConfig):
    learning_rate: float = field(
        default=4e-5, metadata={"help": "learning rate argument"}
    )
    adam_weight_decay: float = field(
        default=0.1, metadata={"help": "Adam weight decay argument"}
    )
    use_8bit_adam: bool = field(
        default=False,
        metadata={
            "help": "true 8-bit optimizer state: int8 block-quantized Adam "
            "moments (trainers/adam8bit.py), the TPU-native analog of the "
            "reference's bitsandbytes AdamW8bit — ~4x less optimizer HBM "
            "(measured 1.75GB vs 6.88GB on the SD-1.5 UNet)."
        },
    )
    accum_dtype: str = field(
        default="f32",
        metadata={
            "help": "gradient-accumulator storage dtype (f32|bf16). bf16 "
            "halves the accumulator's HBM (3.44GB -> 1.72GB on the SD-1.5 "
            "UNet) — at 512-scale the f32 accumulator OOMs the chip even at "
            "batch 2, so bf16 is what makes --gradient-accumulation-steps "
            "fit; accumulation math stays f32, only the store rounds. "
            "Requires the fused optimizer (ignored with --no-fused-adamw).",
            "choices": ["f32", "bf16"],
        },
    )
    no_fused_adamw: bool = field(
        default=False,
        metadata={
            "help": "disable the default single-pass fused AdamW (clip + "
            "moments + bias correction + decay + apply in one HBM pass per "
            "leaf) and use the optax chain instead — e.g. to resume a "
            "checkpoint saved with the optax opt_state layout."
        },
    )
    adam_mu_dtype: str = field(
        default="f32",
        metadata={
            "help": "storage dtype of AdamW's first moment: f32, or bf16 to "
            "halve its HBM footprint/traffic (~1.7GB on the SD-1.5 UNet; the "
            "update math still runs in f32).",
            "choices": ["f32", "bf16"],
        },
    )
    adam_nu_dtype: str = field(
        default="f32",
        metadata={
            "help": "storage dtype of AdamW's second moment (fused path "
            "only): f32, or bf16 to halve its HBM footprint/traffic — a "
            "stability trade (~2^-10 relative error on the update through "
            "the sqrt; moment math stays f32). For a 4x state cut use "
            "--use-8bit-adam instead.",
            "choices": ["f32", "bf16"],
        },
    )
    max_grad_norm: float = field(
        default=0.1, metadata={"help": "max grad norm argument"}
    )
    scheduler_type: str = field(
        default="linear", metadata={"help": "scheduler type argument"}
    )
    lr_warmup_steps: int = field(
        default=500, metadata={"help": "learning rate warm-up steps argument"}
    )


@dataclass
class CheckpointConfig(BaseConfig):
    keep_last_only: bool = field(
        default=False,
        metadata={"help": "whether only keep the last ckpt"},
    )
    ckpt_dir: str = field(
        default="model",
        metadata={"help": "dir to save and load checkpoints"},
    )
    resume_from_checkpoint: Optional[str] = field(
        default=None,
        metadata={
            "help": "dir to load checkpoints from, None refers to a new run, pass latest for a latest resume"
        },
    )
    checkpointing_steps: Optional[str] = field(
        default="100",
        metadata={
            "help": "Whether the various states should be saved at the end of every n steps, or 'epoch'",
        },
    )
