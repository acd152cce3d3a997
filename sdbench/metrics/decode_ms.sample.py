"""Device ms of one VAE decode of the batch: CUDA events around each
LatentDiffusion.decode_latent call of the window, their mean (moves images_per_s)."""


def read(rec):
    ms = rec.get("decode_ms") or []
    return sum(ms) / len(ms) if ms else None
