"""Stage-readiness drill of the PyTorch port (counterpart of tools/stage_check.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.stage_check [--model-dir data/pretrained] \\
        [--only unet,vae] [--device cuda]

Per artifact it runs the port's loader on what is staged under
``--model-dir`` and a check on the loaded model, or reports what to stage:

  tokenizer      tokenizer/{vocab.json,merges.txt}  -> ``models/bpe.py``
                 ``CLIPBPETokenizer.from_dir``; token-for-token against HF
                 ``CLIPTokenizer`` on a probe corpus when ``transformers``
                 imports and loads the vocabulary (``hf-parity``), else the
                 port's ids alone (``self-only (transformers unavailable)``,
                 or naming the version that did not load it)
  text_encoder   text_encoder/model.safetensors or pytorch_model.bin (HF
                 CLIPTextModel names) -> ``models/clip.py:load_text_encoder``
                 into a tower shaped from the weights (heads from
                 ``config.json``) and a forward; against HF ``CLIPTextModel``
                 on the CPU within 1e-3 when ``transformers`` imports
                 (``hf-parity``), else ``load+forward only (ImportError)``
  vae            vae/ (diffusers: config.json + weights) ->
                 ``models/diffusers_vae.py:load_diffusers_vae``, an encode /
                 decode round trip that must be finite; against diffusers'
                 ``AutoencoderKL`` within 5e-3 when ``diffusers`` imports
                 (``diffusers-parity``), else ``load-only (ImportError)``
  unet           unet.pt (reference names) ->
                 ``utils/checkpoint.py:load_reference_checkpoint``, the
                 configuration inferred as the JAX tool infers it (the
                 ``unet_config.json`` sidecar, else the candidates [160, 320],
                 SD-1.5 and [ch0, 2 ch0] whose first width is conv_in's), a
                 strict load and a 1x16x16x4 probe forward in float32 that
                 must be finite; on a card that forward against the same
                 weights on the CPU within 1e-3 (``cpu-parity``), with
                 ``--device cpu`` the forward alone (``load+forward only``).
                 The JAX tool's ``torch-parity`` against the original
                 reference repository is not run: the port imports nothing
                 of it
  inception      inception/inception_v3.{npz,safetensors,pth} -> the
                 canonical FID extractor (``utils/fid.py``): FID of a set
                 with itself at the floor, of the set shifted by 0.5 well
                 above it
  clip_vision    clip_full/model.safetensors (HF CLIPModel) ->
                 ``models/clip_vision.py:CLIPScorer`` with towers shaped from
                 the weights, a finite probe score

A mode that names a missing package is not a failure. Prints ONE JSON line
``{"model_dir", "checks": {artifact: {"status": ok|missing|failed, ...}},
"missing", "failed"}`` and a summary on stderr. Exit 0 (``main`` returns
the line's dict) = every staged artifact passed; 2 = nothing failed but
artifacts are missing; 1 = a staged artifact failed its check. ``--device``
(default ``cuda``; without a card the run stops unless given ``--device
cpu``) is the port's own: every model runs there in float32.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import traceback

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.config import ClipConfig, UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer
from stable_diffusion_pytorch_tpu_torch.models.build import require_device, without_default_init
from stable_diffusion_pytorch_tpu_torch.models.clip import (
    CLIPTextTransformer,
    load_clip_state,
    load_text_encoder,
    resolve_tokenizer,
    tower_state,
)
from stable_diffusion_pytorch_tpu_torch.models.clip_vision import CLIPScorer, load_full_clip_state
from stable_diffusion_pytorch_tpu_torch.models.diffusers_vae import load_diffusers_vae
from stable_diffusion_pytorch_tpu_torch.models.inception import load_inception_state
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_reference_checkpoint
from stable_diffusion_pytorch_tpu_torch.utils.fid import InceptionFeatureExtractor, fid_between
from stable_diffusion_pytorch_tpu_torch.utils.precision import full_float32

PROBE_SENTENCES = [
    "a photograph of an astronaut riding a horse",
    "A majestic lion jumping from a big stone at night, 4k, trending",
    "Hello, World! Ça va? naïve café — emoji 🌊 test",
    "",
    "x" * 300,
]
UNET_PARITY_TOL = 1e-3  # the JAX tool's torch-parity bar, here card vs CPU


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _heads(config_path: str, *keys: str):
    """``num_attention_heads`` under ``keys`` of an HF ``config.json``, or None."""
    if not os.path.exists(config_path):
        return None
    with open(config_path) as f:
        conf = json.load(f)
    for key in keys:
        conf = conf.get(key, {})
    return conf.get("num_attention_heads")


def _tower_kwargs(state: dict, prefix: str, heads) -> dict:
    """A CLIP tower's widths from its weights (``prefix``: ``text_model.`` or
    ``vision_model.``)."""
    layers = {k.split(".")[3] for k in state if k.startswith(prefix + "encoder.layers.")}
    d_model = int(state[f"{prefix}encoder.layers.0.mlp.fc1.weight"].shape[1])
    kw = dict(d_model=d_model, n_layers=len(layers),
              intermediate=int(state[f"{prefix}encoder.layers.0.mlp.fc1.weight"].shape[0]))
    if prefix == "text_model.":
        kw["vocab_size"] = int(state[f"{prefix}embeddings.token_embedding.weight"].shape[0])
        kw["max_positions"] = int(state[f"{prefix}embeddings.position_embedding.weight"].shape[0])
        kw["n_heads"] = int(heads or (12 if d_model % 12 == 0 else 8))
    else:
        patch = int(state[f"{prefix}embeddings.patch_embedding.weight"].shape[-1])
        grid = int(round((state[f"{prefix}embeddings.position_embedding.weight"].shape[0] - 1) ** 0.5))
        kw.update(image_size=patch * grid, patch_size=patch, n_heads=int(heads or (16 if d_model % 16 == 0 else 12)))
    return kw


def hf_tokenizer(tok_dir: str):
    """(HF ``CLIPTokenizer`` loaded from ``tok_dir``, None), or (None, why
    not): ``transformers`` does not import, or the tokenizer it builds does
    not hold the directory's vocabulary (transformers 5 ignores the
    ``vocab_file`` argument the JAX tool passes and builds an empty one)."""
    try:
        from transformers import CLIPTokenizer
        import transformers
    except ImportError:
        return None, "transformers unavailable"
    try:
        hf = CLIPTokenizer.from_pretrained(tok_dir)
    except (OSError, ValueError) as exc:
        return None, f"transformers {transformers.__version__}: {type(exc).__name__}"
    with open(os.path.join(tok_dir, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    if any(hf.convert_tokens_to_ids(tok) != i for tok, i in vocab.items()):
        return None, f"transformers {transformers.__version__} did not load the vocabulary"
    return hf, None


def check_tokenizer(model_dir: str, device) -> dict:
    tok_dir = os.path.join(model_dir, "tokenizer")
    vocab, merges = (os.path.join(tok_dir, f) for f in ("vocab.json", "merges.txt"))
    if not (os.path.exists(vocab) and os.path.exists(merges)):
        return {"status": "missing", "stage": "tokenizer/{vocab.json,merges.txt} (HF CLIPTokenizer files)"}
    ours = CLIPBPETokenizer.from_dir(tok_dir)
    hf, why_not = hf_tokenizer(tok_dir)
    if hf is None:
        ids = ours(PROBE_SENTENCES, padding="max_length").input_ids
        return {"status": "ok", "mode": f"self-only ({why_not})", "shape": list(ids.shape)}
    mismatches = [s[:40] for s in PROBE_SENTENCES
                  if list(ours([s], max_length=77, padding="max_length", truncation=True).input_ids[0])
                  != list(hf(s, max_length=77, padding="max_length", truncation=True)["input_ids"])]
    if mismatches:
        return {"status": "failed", "mode": "hf-parity", "mismatched_sentences": mismatches}
    return {"status": "ok", "mode": "hf-parity", "sentences_checked": len(PROBE_SENTENCES)}


def check_text_encoder(model_dir: str, device) -> dict:
    te_dir = os.path.join(model_dir, "text_encoder")
    state = load_clip_state(model_dir)
    if state is None:
        return {"status": "missing", "stage": "text_encoder/model.safetensors (HF CLIPTextModel state dict)"}
    kw = _tower_kwargs(tower_state(state), "text_model.", _heads(os.path.join(te_dir, "config.json")))
    with torch.device(device), without_default_init():
        tower = CLIPTextTransformer(**kw)
    load_text_encoder(tower, model_dir)
    ids = np.random.default_rng(0).integers(0, kw["vocab_size"], (2, kw["max_positions"])).astype(np.int64)
    with torch.no_grad(), full_float32():
        ours = tower.eval()(torch.from_numpy(ids).to(device)).cpu().numpy()
    if not np.all(np.isfinite(ours)):
        return {"status": "failed", "error": "non-finite hidden states"}
    shape = {k: kw[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads")}
    try:
        from transformers import CLIPTextConfig, CLIPTextModel
    except ImportError as exc:
        return {"status": "ok", "mode": f"load+forward only ({type(exc).__name__})", **shape}
    hf = CLIPTextModel(CLIPTextConfig(
        vocab_size=kw["vocab_size"], hidden_size=kw["d_model"], num_hidden_layers=kw["n_layers"],
        num_attention_heads=kw["n_heads"], intermediate_size=kw["intermediate"],
        max_position_embeddings=kw["max_positions"])).eval()
    hf.text_model.load_state_dict({k.removeprefix("text_model."): v for k, v in tower_state(state).items()},
                                  strict=False)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).last_hidden_state.numpy()
    delta = float(np.max(np.abs(ours - theirs)))
    return {"status": "ok" if delta <= 1e-3 else "failed", "mode": "hf-parity", "max_abs_delta": round(delta, 8),
            **shape}


def check_vae(model_dir: str, device) -> dict:
    vae_dir = os.path.join(model_dir, "vae")
    if not os.path.isdir(vae_dir):
        return {"status": "missing",
                "stage": "vae/ (diffusers AutoencoderKL dir: config.json + diffusion_pytorch_model.safetensors)"}
    vae = load_diffusers_vae(vae_dir, device)
    if vae is None:
        return {"status": "failed", "error": "load_diffusers_vae returned None"}
    img = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad(), full_float32():
        z = vae.float().encode(img.to(device)).mean
        recon = vae.decode(z).cpu().numpy()
    z = z.cpu().numpy()
    if not np.all(np.isfinite(recon)):
        return {"status": "failed", "error": "non-finite decode"}
    out = {"latent_shape": list(z.shape)}
    try:
        from diffusers import AutoencoderKL as DiffusersVAE
    except ImportError as exc:
        return {**out, "status": "ok", "mode": f"load-only ({type(exc).__name__})"}
    ref = DiffusersVAE.from_pretrained(vae_dir).eval()
    with torch.no_grad():
        mean = ref.encode(img.permute(0, 3, 1, 2)).latent_dist.mean
        ref_recon = ref.decode(mean).sample.permute(0, 2, 3, 1).numpy()
    delta_mean = float(np.max(np.abs(mean.permute(0, 2, 3, 1).numpy() - z)))
    delta_recon = float(np.max(np.abs(ref_recon - recon)))
    return {**out, "status": "ok" if max(delta_mean, delta_recon) <= 5e-3 else "failed", "mode": "diffusers-parity",
            "max_abs_delta_encode": round(delta_mean, 8), "max_abs_delta_decode": round(delta_recon, 8)}


def unet_candidates(sd: dict, model_dir: str) -> list:
    """The configurations to try for a reference-format UNet state dict, as
    the JAX tool infers them: ``unet_config.json`` beside ``unet.pt`` pins the
    architecture; else the reference default [160, 320], SD-1.5 and [ch0,
    2 ch0], those whose first width is conv_in's; the time-embedding and
    context widths from the weights."""
    ch0 = int(sd["conv_in.weight"].shape[0])
    ctx_keys = [k for k in sd if k.endswith("cross_attn.to_k.weight")]
    extra = {}
    sidecar = os.path.join(model_dir, "unet_config.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            extra = json.load(f)
    if "channels_list" in extra:
        lists = [list(extra.pop("channels_list"))]
    else:
        lists = [c for c in ([160, 320], [320, 640, 1280, 1280], [ch0, ch0 * 2]) if c[0] == ch0]
    extra.setdefault("time_emb_dim", int(sd["time_embedding.0.weight"].shape[0]))
    extra.setdefault("context_dim", int(sd[ctx_keys[0]].shape[1]) if ctx_keys else 768)
    return [(channels, extra) for channels in lists]


def unet_probe_inputs(context_dim: int):
    """The probe's latent [1, 16, 16, 4], timestep and context, from the JAX tool's generator."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, context_dim)).astype(np.float32)
    return x, np.array([5], np.int64), ctx


def unet_probe(unet, context_dim: int, device="cpu") -> np.ndarray:
    """The probe forward of ``unet`` on ``device`` in float32."""
    x, t, ctx = (torch.from_numpy(a).to(device) for a in unet_probe_inputs(context_dim))
    with torch.no_grad(), full_float32():
        return unet(x, t, ctx).float().cpu().numpy()


def check_unet(model_dir: str, device) -> dict:
    pt = os.path.join(model_dir, "unet.pt")
    if not os.path.exists(pt):
        return {"status": "missing", "stage": "unet.pt (reference-format torch checkpoint)"}
    sd = load_reference_checkpoint(pt)
    last_err = None
    for channels, extra in unet_candidates(sd, model_dir):
        try:
            cfg = UnetConfig(channels_list=channels, **extra)
            with without_default_init():
                unet = UNetModel(4, 4, cfg, flipped_time_embedding=True, bottleneck_default_groups=True)
            unet.load_state_dict(sd, strict=True)
        except (TypeError, ValueError, RuntimeError) as exc:  # the next candidate
            last_err = f"{channels}: {type(exc).__name__}: {exc}"
            continue
        out = unet_probe(unet.eval(), cfg.context_dim)
        result = {"channels_list": channels, "params": int(sum(v.numel() for v in sd.values()))}
        if not np.all(np.isfinite(out)):
            return {**result, "status": "failed", "error": "non-finite forward"}
        if device.type == "cpu":
            return {**result, "status": "ok", "mode": "load+forward only (--device cpu)"}
        card = unet_probe(copy.deepcopy(unet).to(device), cfg.context_dim, device)
        delta = float(np.max(np.abs(card - out)))
        return {**result, "status": "ok" if delta <= UNET_PARITY_TOL else "failed", "mode": "cpu-parity",
                "max_abs_delta": round(delta, 8), "tol": UNET_PARITY_TOL}
    return {"status": "failed", "error": f"no candidate config loaded: {last_err}"}


def check_inception(model_dir: str, device) -> dict:
    state = load_inception_state(model_dir)
    if state is None:
        return {"status": "missing",
                "stage": "inception/inception_v3.{npz,safetensors,pth} (torchvision inception_v3 state dict)"}
    extractor = InceptionFeatureExtractor(state=state, device=device)
    rng = np.random.default_rng(0)
    imgs_a = [rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32) for _ in range(8)]
    imgs_b = [np.clip(a + 0.5, -1, 1) for a in imgs_a]
    same = fid_between(extractor, imgs_a, imgs_a, batch_size=4)
    diff = fid_between(extractor, imgs_a, imgs_b, batch_size=4)
    ok = abs(same) < 0.5 and diff > abs(same) * 10
    return {"status": "ok" if ok else "failed", "fid_identical": round(same, 4), "fid_shifted": round(diff, 4),
            "note": "canonical Inception FID ready (scripts/fid_eval.py FID_EXTRACTOR=inception)"}


def check_clip_vision(model_dir: str, device) -> dict:
    state = load_full_clip_state(model_dir)
    if state is None:
        return {"status": "missing",
                "stage": "clip_full/model.safetensors (full HF CLIPModel, e.g. openai/clip-vit-large-patch14)"}
    conf = os.path.join(model_dir, "clip_full", "config.json")
    text_cfg = _tower_kwargs(state, "text_model.", _heads(conf, "text_config"))
    vision_cfg = _tower_kwargs(state, "vision_model.", _heads(conf, "vision_config"))
    scorer = CLIPScorer(resolve_tokenizer(ClipConfig(model_dir=model_dir)), model_dir=model_dir, text_cfg=text_cfg,
                        vision_cfg=vision_cfg, device=device)
    img = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    score = scorer.score(img, ["a probe caption"])
    return {"status": "ok" if np.isfinite(score) else "failed", "pretrained": scorer.pretrained,
            "probe_score": round(score, 4)}


CHECKS = {
    "tokenizer": check_tokenizer,
    "text_encoder": check_text_encoder,
    "vae": check_vae,
    "unet": check_unet,
    "inception": check_inception,
    "clip_vision": check_clip_vision,
}


def run(model_dir: str, names=None, device="cpu") -> dict:
    """The checks ``names`` (all by default) over ``model_dir`` -> the report
    ``{"model_dir", "checks", "missing", "failed"}``."""
    device = torch.device(device)
    report = {}
    for name in names or CHECKS:
        log(f"[stage_check] {name}...")
        try:
            report[name] = CHECKS[name](model_dir, device)
        except Exception as exc:  # noqa: BLE001 -- a staged artifact that breaks its loader fails its check
            report[name] = {"status": "failed", "error": f"{type(exc).__name__}: {exc}",
                            "traceback": traceback.format_exc()[-1500:]}
        log(f"[stage_check] {name}: {report[name]['status']}")
    return {"model_dir": model_dir, "checks": report,
            "missing": [n for n, r in report.items() if r["status"] == "missing"],
            "failed": [n for n, r in report.items() if r["status"] == "failed"]}


def exit_code(summary: dict) -> int:
    """1 when a staged artifact failed, else 2 when one is missing, else 0."""
    return 1 if summary["failed"] else 2 if summary["missing"] else 0


def main(argv=None) -> dict:
    """Run the checks and print the JSON line -> its dict; exits 2 or 1 as the module docstring says."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-dir", default="data/pretrained")
    parser.add_argument("--only", default=None, help=f"comma-separated subset of {sorted(CHECKS)}")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    args = parser.parse_args(argv)
    try:
        device = require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"stage_check: {exc}") from None

    summary = run(args.model_dir, args.only.split(",") if args.only else None, device)
    print(json.dumps(summary), flush=True)
    code = exit_code(summary)
    if code == 1:
        log(f"FAILED: {summary['failed']}")
    elif code == 2:
        log("Missing artifacts; stage these:")
        for n in summary["missing"]:
            log(f"  {n}: {summary['checks'][n]['stage']}")
    else:
        log("All staged artifacts verified.")
    if code:
        sys.exit(code)
    return summary


if __name__ == "__main__":
    main()
