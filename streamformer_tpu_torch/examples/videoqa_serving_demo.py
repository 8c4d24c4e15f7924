"""VideoQA serving end to end: tower -> splice -> continuous batching.

A toy-size walkthrough of the serving path (on the card, or the CPU with
``--device cpu``):

1. build a toy tower, projector and LM (swap in real checkpoints through
   ``checkpoint.from_pretrained`` and
   ``models.language_model.convert_hf_state_dict``),
2. three questions about three different videos become spliced prompt
   embeddings (``LlavaQwenModel.prompt_embeds``),
3. the ``DecodeEngine`` serves them concurrently over 2 slots: the answers
   equal lone ``model.generate`` calls,
4. the same engine goes behind HTTP (``server.DecodeServer``) and request
   #4 arrives over a real socket.

Run: python -m streamformer_tpu_torch.examples.videoqa_serving_demo [--device cpu]
"""

import argparse
import base64
import json
import time
import urllib.request

import numpy as np
import torch

from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.downstream import videoqa as VQ
from streamformer_tpu_torch.downstream.vision_tower import TimesformerVisionTower
from streamformer_tpu_torch.lm_serving import DecodeEngine
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.models import language_model as LM
from streamformer_tpu_torch.server import DecodeServer


def main(argv=None):
    p = argparse.ArgumentParser(description="VideoQA serving demo")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = encoder.resolve_device(args.device)
    cfg = StreamformerConfig(image_size=32, patch_size=16, num_frames=4, hidden_size=64,
                             num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                             dtype="float32")
    lm_cfg = LM.LMConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                         tie_word_embeddings=True)
    tower = encoder.StreamformerEncoder(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    lm = LM.LanguageModel(lm_cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    proj = VQ.init_mm_projector(cfg.hidden_size, lm_cfg.hidden_size, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(2))
    model = VQ.LlavaQwenModel(tower=TimesformerVisionTower(tower, streaming_mode=False), lm=lm,
                              projector=proj)

    rng = np.random.default_rng(0)
    videos = [torch.from_numpy(rng.standard_normal((1, 4, 3, 32, 32), dtype=np.float32)).to(dev)
              for _ in range(3)]
    prompts = [np.array([3, VQ.IMAGE_TOKEN_INDEX, 9 + i, 12]) for i in range(3)]

    # lone answers (the reference-style one-at-a-time path)
    lone = [model.generate(q, v, max_new_tokens=4)[0].tolist() for q, v in zip(prompts, videos)]

    # continuous batching: all three concurrently over 2 slots
    eng = DecodeEngine(lm, slots=2, capacity=32, max_new_tokens=4, prefill_buckets=(8, 16))
    rids = [eng.open(model.prompt_embeds(q, v)) for q, v in zip(prompts, videos)]
    eng.run_until_idle()
    for i, rid in enumerate(rids):
        toks, done = eng.poll(rid)
        print(f"request {rid}: engine {toks} {'==' if lone[i] == toks else '!='} lone {lone[i]}")
        if not (done and lone[i] == toks):
            raise SystemExit(f"request {rid}: the engine's answer differs from the lone one")

    # the same engine behind HTTP
    srv = DecodeServer(lm, port=0, slots=2, capacity=32, max_new_tokens=4,
                       prefill_buckets=(8, 16)).start()
    try:
        emb = model.prompt_embeds(prompts[0], videos[0]).float().cpu().numpy()
        body = json.dumps({"embeds_b64": base64.b64encode(np.ascontiguousarray(emb).tobytes())
                           .decode(), "shape": list(emb.shape)}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/requests", data=body,
                                     method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            rid = json.loads(r.read())["rid"]
        toks, deadline = [], time.time() + 60
        while time.time() < deadline:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/requests/{rid}/tokens",
                                        timeout=30) as r:
                out = json.loads(r.read())
            toks += out["tokens"]
            if out["done"]:
                break
            time.sleep(0.05)
        print(f"HTTP request {rid}: {toks} (expected {lone[0]})")
        if toks != lone[0]:
            raise SystemExit("the HTTP answer differs from the lone one")
    finally:
        srv.stop()
    print("videoqa serving demo OK")
    return {"lone": lone, "http": toks}


if __name__ == "__main__":
    main()
