"""How far the streamed frames lie from the full clip on the card, and why.

Run from the root of a checkout on a machine with a CUDA card:

    python -m streamformer_tpu_torch.tools.stream_divergence

At the flagship width (768 hidden, 12 layers, 12 heads, 224x224, T=16,
batch 8, seeded random weights with the time and position tables drawn),
it prints for each variant the max-abs difference between frame i of 16
streamed frames and frame i of the full clip, hidden and pooled:

- fp32, and bf16 with temporal gates 0.5 (the kernels);
- bf16 with the attention's plain PyTorch versions on the card in place of
  the kernels (the kernels are restored afterwards);
- bf16 with the temporal gates closed (0.0): what everything outside the
  temporal attention contributes;
- a full clip at batch 4 against the first half of the batch-8 clip: whether
  the non-attention operations give the same result per row whatever the
  batch;
- the bf16 full clip against the fp32 full clip: bf16's own error.
"""

import contextlib

import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.ops import attention as ops

KERNELS = ("spatial_flat", "temporal_fullclip", "temporal_decode_pm")


def build(dtype: str, gate: float) -> encoder.StreamformerEncoder:
    cfg = StreamformerConfig(dtype=dtype, cache_capacity=16)
    model = encoder.StreamformerEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for layer in model.encoder.layer:
            layer.temporal_attention_gating.fill_(gate)
        for p in (model.embeddings.time_embeddings, model.embeddings.position_embeddings):
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model.to("cuda")


@contextlib.contextmanager
def plain_attention():
    """The ops module's wrappers replaced by their plain versions."""
    saved = {name: getattr(ops, name) for name in KERNELS}
    for name in KERNELS:
        setattr(ops, name, getattr(ops, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def report(tag: str, model, video) -> dict:
    full = model(video)
    half = model(video[:4])
    batch = {k: max_err(half[k], full[k][:4]) for k in full}
    cache = model.init_cache(video.shape[0])
    hidden, pooled = [], []
    for i in range(video.shape[1]):
        out, cache = model.stream(video[:, i:i + 1], cache)
        hidden.append(max_err(out["last_hidden_state"], full["last_hidden_state"][:, i:i + 1]))
        pooled.append(max_err(out["pooler_output"], full["pooler_output"][:, i:i + 1]))
    print(f"[{tag}] stream vs full clip, max over frames: hidden {max(hidden)} pooled {max(pooled)}")
    print(f"[{tag}]   per frame hidden {hidden}")
    print(f"[{tag}] full clip batch 4 vs batch 8: hidden {batch['last_hidden_state']} "
          f"pooled {batch['pooler_output']}")
    return full


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stream_divergence: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    video = torch.randn(8, 16, 3, 224, 224, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    full32 = report("fp32, kernels", build("float32", 0.5), video)
    model = build("bfloat16", 0.5)
    full16 = report("bf16, kernels", model, video)
    with plain_attention():
        report("bf16, plain attention on the card", model, video)
    report("bf16, temporal gates closed", build("bfloat16", 0.0), video)
    print(f"[bf16 vs fp32 full clip] hidden "
          f"{max_err(full16['last_hidden_state'], full32['last_hidden_state'])} pooled "
          f"{max_err(full16['pooler_output'], full32['pooler_output'])}")


if __name__ == "__main__":
    main()
