"""The port's OVIS path (MSDeformAttn, the ViT-Adapter, the position-table
resize, the Mask2Former segmentor, the matcher and criterion, the CTVIS
losses, the trackers, a training step of ``ovis_run`` and its inference
with the YTVIS scorer) against the JAX package's, on the CPU in fp32.

Both sides start from the same numpy weights (the JAX trees carried across
by ``params_from_jax``, ``adapter_params_from_jax`` and
``segmentor_params_from_jax``); inputs come from this file's own
``np.random.default_rng`` seeds. Each of the adapter's XLA semantics that a
torch port gets wrong by default (SAME padding at stride 2, batch-statistics
norms, the unflipped transposed-conv kernel, the antialiased linear resize)
has a case of its own.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.downstream import ctvis_plugin as jax_cl
from streamformer_tpu.downstream import segmentor as jax_seg
from streamformer_tpu.eval import ytvis as jax_ytvis
from streamformer_tpu.models import adapter as jax_adapter
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.ops import msdeform_attn as jax_msda
from streamformer_tpu_torch.checkpoint import (adapter_params_from_jax, params_from_jax,
                                               segmentor_params_from_jax)
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.data.transforms import resize
from streamformer_tpu_torch.downstream import ctvis_plugin, ovis_run, segmentor
from streamformer_tpu_torch.eval import ytvis
from streamformer_tpu_torch.models import adapter, encoder
from streamformer_tpu_torch.ops import msdeform_attn

from test_torch_encoder import _jax_params

# tests/test_adapter.py's backbone and adapter
TOWER = dict(image_size=64, patch_size=16, num_frames=2, hidden_size=32, num_hidden_layers=4,
             num_attention_heads=4, intermediate_size=64, dtype="float32")
JCFG = JaxConfig(use_pallas=False, **TOWER)
CFG = StreamformerConfig(**TOWER)
INTER = [[0, 1], [2, 3]]
ADAPTER = dict(conv_inplane=8, deform_num_heads=4, interaction_indexes=INTER)
# tests/test_segmentor.py's segmentor
SEG = dict(hidden_dim=32, num_queries=8, num_classes=5, nheads=4, dim_feedforward=64,
           enc_layers=1, dec_layers=3, mask_dim=32, in_dim=32)
JSEG = jax_seg.SegmentorConfig(**SEG)
PSEG = segmentor.SegmentorConfig(**SEG)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(a, b):
    a, b = (x.detach() if isinstance(x, torch.Tensor) else x for x in (a, b))
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _draw(init, seed):
    """A JAX parameter tree of ``init``'s structure (``jax.eval_shape``: no
    JAX initialiser runs) drawn from numpy: norms' scales near 1, biases and
    embeddings small, kernels scaled by their fan-in. Every leaf matters
    (the sampling offsets and attention weights of MSDeformAttn, zero in
    the reference init, vary with the query too)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) < 2 or name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


@pytest.fixture(scope="module")
def weights():
    backbone = _jax_params(JCFG, seed=11)
    ad = _draw(lambda: jax_adapter.init_adapter_params(jax.random.PRNGKey(1), JCFG, **ADAPTER), 12)
    seg = _draw(lambda: jax_seg.init_segmentor(jax.random.PRNGKey(2), JSEG), 13)
    return backbone, ad, seg


def _port_backbone(backbone):
    model = encoder.StreamformerEncoder(CFG, device="cpu")
    model.load_state_dict(params_from_jax(backbone, CFG))
    return model


def _port_adapter(tree):
    model = adapter.Adapter(CFG, device="cpu", **ADAPTER)
    model.load_state_dict(adapter_params_from_jax(tree))
    return model


def _port_segmentor(tree):
    model = segmentor.Segmentor(PSEG, device="cpu")
    model.load_state_dict(segmentor_params_from_jax(tree))
    return model


def _pixels(seed=0, b=1, size=64):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 2, 3, size, size)).astype(np.float32)


# ---------------------------------------------------------------------------
# MSDeformAttn
# ---------------------------------------------------------------------------


def test_ms_deform_attn_core_and_gradients_match_jax():
    """Three levels, sampling points inside, on the border and outside the
    maps (a corner outside adds zero); the output and its gradients with
    respect to the value, the locations and the weights within 1e-5."""
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (3, 4), (2, 2)]
    b, lq, m, d, p = 2, 7, 2, 4, 3
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, lq, m, len(shapes), p, 2)).astype(np.float32)
    loc[0, 0, 0, 0, 0] = [0.0, 1.0]  # on the border
    assert (loc < 0).any() and (loc > 1).any()
    weights = rng.uniform(0, 1, (b, lq, m, len(shapes), p)).astype(np.float32)
    cot = rng.standard_normal((b, lq, m * d)).astype(np.float32)

    want, vjp = jax.jit(lambda *a: jax.vjp(
        lambda v, l_, w: jax_msda.ms_deform_attn_core(v, shapes, l_, w), *a))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(weights))
    want_grads = vjp(jnp.asarray(cot))
    args = [_t(x).requires_grad_() for x in (value, loc, weights)]
    got = msdeform_attn.ms_deform_attn_core(args[0], shapes, args[1], args[2])
    assert _err(got.detach(), want) <= 1e-5
    (got * _t(cot)).sum().backward()
    for a, g in zip(args, want_grads):
        assert _err(a.grad, g) <= 1e-5


def test_ms_deform_attn_module_matches_jax():
    rng = np.random.default_rng(1)
    shapes = [(4, 4), (2, 2)]
    tree = jax.tree.map(np.asarray, jax_msda.init_msdeform_params(jax.random.PRNGKey(0), 16,
                                                                   len(shapes), 4, 2))
    tree["sampling_offsets"]["kernel"] = 0.1 * rng.standard_normal(
        tree["sampling_offsets"]["kernel"].shape).astype(np.float32)
    tree["attention_weights"]["kernel"] = rng.standard_normal(
        tree["attention_weights"]["kernel"].shape).astype(np.float32)
    module = msdeform_attn.MSDeformAttn(16, len(shapes), 4, 2)
    module.load_state_dict(segmentor_params_from_jax(tree))
    query = rng.standard_normal((2, 5, 16)).astype(np.float32)
    value = rng.standard_normal((2, 20, 16)).astype(np.float32)
    ref = rng.uniform(0, 1, (2, 5, len(shapes), 2)).astype(np.float32)
    want = jax_msda.ms_deform_attn(tree, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value),
                                   shapes, n_heads=4, n_points=2)
    got = msdeform_attn.ms_deform_attn(module, _t(query), _t(ref), _t(value), shapes)
    assert _err(got.detach(), want) <= 1e-5


# ---------------------------------------------------------------------------
# the adapter's traps, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [16, 15])
def test_same_padding_at_stride_two(size):
    """XLA's SAME at stride 2 pads 0 before and 1 after on an even input;
    torch's padding=1 shifts the grid there."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    want = jax_adapter._conv(jnp.asarray(x), jnp.asarray(k), 2)
    conv = torch.nn.Conv2d(3, 5, 3, bias=False)
    conv.weight.data = _t(k.transpose(3, 2, 0, 1))
    got = adapter._conv_same(_t(x).permute(0, 3, 1, 2), conv, 2).permute(0, 2, 3, 1)
    assert _err(got, want) <= 1e-5
    sym = F.conv2d(_t(x).permute(0, 3, 1, 2), conv.weight, stride=2, padding=1)
    if size % 2 == 0:
        assert _err(sym.permute(0, 2, 3, 1), want) > 1e-2


def test_norms_take_batch_statistics():
    """The JAX package's _bn always normalises by the batch's own biased
    statistics; an eval-mode BatchNorm (running statistics) does not."""
    rng = np.random.default_rng(3)
    x = (2 + 3 * rng.standard_normal((4, 5, 6, 7))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(7)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(7)).astype(np.float32)}
    norm = adapter.Norm(7)
    norm.weight.data, norm.bias.data = _t(p["scale"]), _t(p["bias"])
    want = jax_adapter._bn(jnp.asarray(x), p)
    assert _err(adapter._bn(_t(x), norm, -1).detach(), want) <= 1e-5
    nchw = adapter._bn(_t(x).permute(0, 3, 1, 2), norm, 1).permute(0, 2, 3, 1)
    assert _err(nchw.detach(), want) <= 1e-5
    bn = torch.nn.BatchNorm2d(7).eval()
    bn.weight.data, bn.bias.data = _t(p["scale"]), _t(p["bias"])
    assert _err(bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach(), want) > 0.1


def test_transposed_conv_kernel_is_flipped():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    tree = {"up": {"kernel": rng.standard_normal((2, 2, 6, 6)).astype(np.float32),
                   "bias": rng.standard_normal(6).astype(np.float32)}}
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(tree["up"]["kernel"]), (2, 2),
                                  "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = want + tree["up"]["bias"]
    sd = adapter_params_from_jax(tree)
    got = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), sd["up.weight"], sd["up.bias"], stride=2)
    assert _err(got.permute(0, 2, 3, 1), want) <= 1e-5
    unflipped = sd["up.weight"].flip(-2, -1)
    bad = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), unflipped, sd["up.bias"], stride=2)
    assert _err(bad.permute(0, 2, 3, 1), want) > 1e-2


@pytest.mark.parametrize("src,dst", [(14, 7), (4, 16), (7, 28), (56, 7)],
                         ids=["down2", "up4", "up4b", "down8"])
def test_linear_resize_is_jax_image_resize(src, dst):
    """jax.image.resize "linear" both ways: on a downscale the triangle is
    widened (antialiasing), which F.interpolate without antialias lacks."""
    x = np.random.default_rng(5).standard_normal((2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "linear")
    assert _err(resize(_t(x), (dst, dst)), want) <= 1e-5
    plain = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(dst, dst), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    if dst < src:
        assert _err(plain, want) > 1e-2


@pytest.mark.parametrize("size", [48, 96], ids=["down", "up"])
def test_interpolate_pos_embeddings_matches_jax(size, weights):
    backbone, _, _ = weights
    pos = backbone["embeddings"]["position_embeddings"]
    hp = size // CFG.patch_size
    want = jax_encoder.interpolate_pos_embeddings(jnp.asarray(pos), hp, hp)
    got = encoder.interpolate_pos_embeddings(_t(pos), hp, hp)
    assert got.shape == want.shape and _err(got, want) <= 1e-5
    px = _pixels(6, size=size)
    want_x = jax_encoder.embed(backbone, jnp.asarray(px), JCFG)
    got_x = encoder.embed(_port_backbone(backbone), _t(px))
    assert _err(got_x, want_x) <= 1e-5


def test_adapter_forward_matches_jax(weights):
    backbone, ad, _ = weights
    px = _pixels(7, b=2)
    want = jax.jit(lambda a, b, x: jax_adapter.adapter_forward(
        a, b, x, JCFG, deform_num_heads=4, interaction_indexes=INTER))(
            ad, backbone, jnp.asarray(px))
    got = adapter.adapter_forward(_port_adapter(ad), _port_backbone(backbone), _t(px))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _err(got[k].detach(), want[k]) <= 1e-4, k


# ---------------------------------------------------------------------------
# the segmentor, the matcher, the criterion and the CTVIS losses
# ---------------------------------------------------------------------------


def _fpn(seed=8, b=2, base=16):
    rng = np.random.default_rng(seed)
    return {f"res{i + 2}": rng.standard_normal((b, base >> i, base >> i, 32)).astype(np.float32)
            for i in range(4)}


def _jax_attention_masks(tree, fpn):
    """The JAX decoder's attention mask of each round, by its own formula
    (segmentor.py:262-266) on its own predictions."""
    memory, shapes, mask_feat = jax_seg.pixel_decoder_forward(tree["pixel_decoder"], fpn, JSEG)
    p = tree["mask_decoder"]
    out = jax_seg.mask_decoder_forward(p, memory, shapes, mask_feat, JSEG)
    qn = jax_seg._ln(jnp.tile(p["query_feat"][None], (2, 1, 1)), p["decoder_norm"])
    first = jnp.einsum("bqc,bhwc->bqhw", jax_seg._mask_embed(p["mask_head"], qn), mask_feat)
    rounds = [first] + [a["pred_masks"] for a in out["aux"]]
    masks = []
    for li, m in enumerate(rounds):
        h, w = shapes[li % len(memory)]
        am = jax.image.resize(m, (m.shape[0], m.shape[1], h, w), "linear")
        am = (jax.nn.sigmoid(am) > 0.5).reshape(m.shape[0], m.shape[1], h * w)
        masks.append(jnp.where(am.any(-1, keepdims=True), am, True))
    return out, masks


def test_segmentor_forward_and_attention_mask_bits_match_jax(weights):
    _, _, tree = weights
    fpn = _fpn()
    want, want_masks = jax.jit(_jax_attention_masks)(tree, fpn)
    got_masks = []
    got = segmentor.segmentor_forward(_port_segmentor(tree), {k: _t(v) for k, v in fpn.items()},
                                      PSEG, got_masks)
    for k in ("pred_logits", "pred_masks", "embeddings"):
        assert got[k].shape == want[k].shape
        assert _err(got[k].detach(), want[k]) <= 1e-4, k
    assert len(got["aux"]) == len(want["aux"]) == PSEG.dec_layers - 1
    for a, b in zip(got["aux"], want["aux"]):
        assert _err(a["pred_masks"].detach(), b["pred_masks"]) <= 1e-4
    assert len(got_masks) == len(want_masks) == PSEG.dec_layers
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g.numpy(), w)
        assert 0 < w.mean() < 1  # the masks select: neither all nor nothing


def _gt(seed=9, size=16):
    rng = np.random.default_rng(seed)
    gt_cls = np.array([[1, 3, 0], [2, -1, 4]])
    gt_masks = (rng.uniform(size=(2, 3, size, size)) > 0.6).astype(np.float32)
    return gt_cls, gt_masks


@pytest.mark.parametrize("gt_size", [16, 32], ids=["same", "resized"])
def test_hungarian_match_and_criterion_match_jax(weights, gt_size):
    _, _, tree = weights
    fpn = _fpn(10)
    want_out = jax.jit(lambda t, f: jax_seg.segmentor_forward(t, f, JSEG))(tree, fpn)
    got_out = segmentor.segmentor_forward(_port_segmentor(tree),
                                          {k: _t(v) for k, v in fpn.items()}, PSEG)
    gt_cls, gt_masks = _gt(size=gt_size)
    matches = []
    for i in range(2):
        valid = gt_cls[i] >= 0
        args = [gt_cls[i][valid], gt_masks[i][valid]]
        want = jax_seg.hungarian_match(np.asarray(want_out["pred_logits"][i]),
                                       np.asarray(want_out["pred_masks"][i]), *args, JSEG)
        got = segmentor.hungarian_match(got_out["pred_logits"][i].detach().numpy(),
                                        got_out["pred_masks"][i].detach().numpy(), *args, PSEG)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        matches.append((got[0], np.flatnonzero(valid)[got[1]]))
    want_loss = jax.jit(lambda o, c, m: jax_seg.criterion(o, matches, c, m, JSEG))(
        want_out, jnp.asarray(gt_cls), jnp.asarray(gt_masks))
    got_loss = segmentor.criterion(got_out, matches, torch.from_numpy(gt_cls), _t(gt_masks),
                                   PSEG).detach()
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * max(1.0, abs(float(want_loss)))


@pytest.mark.parametrize("name", ["CTCLPlugin", "MultiRefCLPlugin", "MultiRefCLPlugin-both"])
def test_ctvis_losses_match_jax(name):
    rng = np.random.default_rng(11)
    embeds = rng.standard_normal((3, 6, 8)).astype(np.float32)
    ids = np.array([[0, 1, 2, -1, 3, -1], [1, 0, -1, 2, -1, -1], [2, -1, 0, 1, 3, -1]])
    extras = {"cl_plugin_name": name.split("-")[0], "one_direction": not name.endswith("both")}
    want_fn = jax.jit(jax.value_and_grad(
        lambda e: jax_cl.cl_loss_from_config(e, jnp.asarray(ids), extras)))
    want, want_grad = want_fn(jnp.asarray(embeds))
    e = _t(embeds).requires_grad_()
    got = ctvis_plugin.cl_loss_from_config(e, torch.from_numpy(ids), extras)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5
    assert _err(e.grad, want_grad) <= 1e-5


# ---------------------------------------------------------------------------
# trackers (tests/test_segmentor.py's sequences)
# ---------------------------------------------------------------------------


def _steal_sequence(mod, match_type):
    tr = mod.HungarianTracker(match_metric="cosine", match_type=match_type, match_score_thr=0.2,
                              embed_type="last")
    out = [tr.update(np.array([[1.0, 0.0], [0.7071, 0.7071]], np.float32),
                     scores=np.array([0.9, 0.9]))]
    out.append(tr.update(np.array([[0.97, 0.24], [1.0, 0.0]], np.float32),
                         scores=np.array([0.9, 0.8])))
    return out


def _occlusion_sequence(mod):
    tr = mod.HungarianTracker(match_metric="cosine", num_dead_frames=3,
                              embed_type="similarity_guided")
    a, b = np.array([[1.0, 0.0]], np.float32), np.array([[0.0, 1.0]], np.float32)
    return [tr.update(e, frame_id=f) for e, f in ((a, 0), (b, 1), (b, 2), (a, 3), (b, 4), (a, 9))]


def _simple_sequence(mod):
    tr = mod.SimpleTracker(sim_threshold=0.3)
    return [tr.update(np.array(e, np.float32)) for e in
            ([[1.0, 0, 0], [0, 1.0, 0]], [[0, 0.9, 0.1], [0.95, 0.05, 0]], [[0, 0, 1.0]])]


def _tracklet_views(mod):
    t = mod._Tracklet(0, maximum_cache=3)
    rng = np.random.default_rng(12)
    for f in range(5):
        t.update(float(rng.uniform()), rng.standard_normal(4).astype(np.float32), f)
    return [t.fused_embed(k) for k in ("last", "momentum", "similarity_guided",
                                       "temporally_weighted_softmax")]


def _video(seed=0, bisoftmax=False):
    rng = np.random.default_rng(seed)
    t, q, c, h, w, d = 4, 6, 3, 8, 8, 8
    logits = rng.standard_normal((t, q, c + 1)).astype(np.float32) * 2
    masks = rng.standard_normal((t, q, h, w)).astype(np.float32) * 4
    masks[:, 1] = masks[:, 0] + 0.1  # a near-duplicate for the NMS
    embeds = rng.standard_normal((t, q, d)).astype(np.float32)
    embeds[1:] = embeds[:1] + 0.1 * embeds[1:]
    return logits, masks, embeds


@pytest.mark.parametrize("case", ["steal-greedy", "steal-hungarian", "occlusion", "simple",
                                  "tracklet", "track_video", "mask_nms"])
def test_trackers_equal_jax(case):
    def run(mod):
        if case.startswith("steal"):
            return _steal_sequence(mod, case.split("-")[1])
        if case == "occlusion":
            return _occlusion_sequence(mod)
        if case == "simple":
            return _simple_sequence(mod)
        if case == "tracklet":
            return _tracklet_views(mod)
        if case == "mask_nms":
            masks = np.random.default_rng(13).uniform(size=(12, 6, 6)) > 0.4
            masks[5] = masks[2]
            return [mod.mask_nms(masks, thr) for thr in (0.3, 0.6)]
        out = []
        for tracker in ("HungarianTracker", "SimpleTracker"):
            frames = mod.track_video(*_video(), mod.make_tracker(tracker, match_metric="cosine"),
                                     inference_select_thr=0.2)
            out.append(frames)
        return out

    got, want = run(segmentor), run(jax_seg)
    assert repr(_plain(got)) == repr(_plain(want))


def _plain(x):
    """Nested outputs as lists of Python numbers (arrays and all)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


# ---------------------------------------------------------------------------
# ovis_run: a training step, inference and the scorer
# ---------------------------------------------------------------------------

TINY_FLAGS = ["--hidden_size", "32", "--num_layers", "4", "--num_heads", "4",
              "--intermediate_size", "64", "--input_size", "64", "--num_classes", "5",
              "--num_queries", "8", "--device", "cpu"]


def _clip(seed=14):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    mt = np.full((2, 64, 64), -1, np.int64)
    mt[0, 4:30, 6:40], mt[1, 8:34, 10:44] = 0, 0
    mt[0, 40:60, 30:60], mt[1, 36:56, 26:56] = 1, 1
    mt[0, 2:10, 50:62] = 2  # an instance in the first frame only
    return {"frames": frames, "mask_target": mt, "selected_classes": np.array([3, 1, 4])}


def test_ovis_train_step_matches_jax(weights, tmp_path):
    """ovis_run.train for one step on one clip, the segmentor's sizes from a
    detectron2 YAML (with a _BASE_), the CLI's adapter (a block a layer of
    a 2-layer backbone, conv_inplane 64): the port's per-frame matches equal
    the JAX package's, its loss and every gradient within 1e-4 of the JAX package's two-phase
    step (ovis_run.py:269-333: the matching forward, the host matching, the
    loss with the CTVIS term). A ReLU or a mask threshold that fp32 noise
    tips across its kink shows as an isolated leaf off by far more; the
    small FFN keeps those rare."""
    seg_tree = weights[2]
    tower = dict(TOWER, num_hidden_layers=2)  # two interaction blocks
    jcfg, cfg = JaxConfig(use_pallas=False, **tower), StreamformerConfig(**tower)
    backbone = _jax_params(jcfg, seed=16)
    inter = jax_adapter.default_interaction_indexes(2)
    ad = _draw(lambda: jax_adapter.init_adapter_params(
        jax.random.PRNGKey(3), jcfg, deform_num_heads=4, interaction_indexes=inter), 17)
    (tmp_path / "base.yaml").write_text(
        "MODEL:\n  SEM_SEG_HEAD:\n    NUM_CLASSES: 5\n    TRANSFORMER_ENC_LAYERS: 1\n"
        "    MASK_DIM: 32\n  MASK_FORMER:\n    NHEADS: 4\n    DIM_FEEDFORWARD: 64\n"
        "    DEC_LAYERS: 3\nSOLVER:\n  BASE_LR: 0.0001\n  WEIGHT_DECAY: 0.05\n")
    (tmp_path / "ctvis.yaml").write_text(
        '_BASE_: ["base.yaml"]\nMODEL:\n  MASK_FORMER:\n    NUM_OBJECT_QUERIES: 8\n')
    flags = [f for f in TINY_FLAGS if f not in ("--num_classes", "5", "--num_queries", "8")]
    flags[flags.index("--num_layers") + 1] = "2"
    args = ovis_run.get_args(["--anno", "x", "--output_dir", str(tmp_path), "--epochs", "1",
                              "--steps_per_epoch", "1", "--num_frames", "2", "--d2_config",
                              str(tmp_path / "ctvis.yaml"), *flags])
    model = ovis_run.build_model(args)
    model.backbone.load_state_dict(params_from_jax(backbone, cfg))
    model.params["adapter"].load_state_dict(adapter_params_from_jax(ad))
    model.params["segmentor"].load_state_dict(segmentor_params_from_jax(seg_tree))
    assert model.seg_cfg == PSEG and (args.lr, args.weight_decay) == (1e-4, 0.05)
    jseg = JSEG

    clip = _clip()
    inst, gt_cls, gms = ovis_run.targets_of(clip)
    px = jnp.asarray(clip["frames"].astype(np.float32).transpose(0, 3, 1, 2)[None] / 127.5 - 1.0)
    params = {"adapter": jax.tree.map(jnp.asarray, ad),
              "segmentor": jax.tree.map(jnp.asarray, seg_tree)}

    def jax_out(p):
        fpn = jax_adapter.adapter_forward(p["adapter"], jax.lax.stop_gradient(backbone), px, jcfg,
                                          deform_num_heads=4,
                                          interaction_indexes=inter)
        return jax_seg.segmentor_forward(p["segmentor"], fpn, jseg)

    out = jax.jit(jax_out)(params)
    want_matches, want_ids = [], np.full((2, 8), -1, np.int64)
    for t in range(2):
        valid = gt_cls[t] >= 0
        qi, gi = jax_seg.hungarian_match(np.asarray(out["pred_logits"][t]),
                                         np.asarray(out["pred_masks"][t]), gt_cls[t][valid],
                                         gms[t][valid], jseg)
        vidx = np.flatnonzero(valid)
        want_matches.append((qi, vidx[gi]))
        want_ids[t, qi] = inst[vidx[gi]]

    def jax_loss(p):
        o = jax_out(p)
        loss = jax_seg.criterion(o, want_matches, jnp.asarray(gt_cls), jnp.asarray(gms), jseg)
        return loss + jax_cl.cl_loss_from_config(o["embeddings"], jnp.asarray(want_ids), {})

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)

    orig_match, seen = ovis_run.match, {}

    def recording_match(*a):
        seen["match"] = orig_match(*a)
        return seen["match"]

    def record_grads():
        seen["grads"] = {k: p.grad.clone() for k, p in model.params.named_parameters()}

    def make(params_, lr, wd):
        opt = orig_make(params_, lr, wd)
        inner = opt.step
        opt.step = lambda: (record_grads(), inner())
        return opt

    orig_make = ovis_run.make_optimizer
    ovis_run.match, ovis_run.make_optimizer = recording_match, make
    try:
        _, history = ovis_run.train(args, [clip], model)
    finally:
        ovis_run.match, ovis_run.make_optimizer = orig_match, orig_make
    matches, ids = seen["match"]
    for (a, b), (c, d) in zip(matches, want_matches):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    np.testing.assert_array_equal(ids, want_ids)
    assert abs(history[0]["loss"] - float(want_loss)) <= 1e-4
    want = {"adapter." + k: v for k, v in adapter_params_from_jax(
        jax.tree.map(np.asarray, want_grads["adapter"])).items()}
    want.update({"segmentor." + k: v for k, v in segmentor_params_from_jax(
        jax.tree.map(np.asarray, want_grads["segmentor"])).items()})
    assert want.keys() == seen["grads"].keys()
    errs = {k: _err(seen["grads"][k], want[k]) for k in want}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert os.path.isdir(tmp_path / "checkpoint-0")


def test_run_inference_on_cv2_frames_and_the_scorer(tmp_path):
    """run_inference over two videos of cv2-written frames (the default
    loader), through HungarianTracker; results.json read back scores the
    same under the JAX package's evaluate_ytvis, and the masks come back at
    each video's resolution by cv2's nearest rule."""
    import cv2

    rng = np.random.default_rng(15)
    videos, annos = [], []
    for vid, (h, w) in enumerate([(48, 80), (72, 60)], start=1):
        names = []
        for f in range(3):
            name = f"v{vid}/{f:03d}.png"
            os.makedirs(tmp_path / f"v{vid}", exist_ok=True)
            cv2.imwrite(str(tmp_path / name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            names.append(name)
        videos.append({"id": vid, "file_names": names, "height": h, "width": w})
        poly = [[4, 4, w // 2, 4, w // 2, h // 2, 4, h // 2]]
        annos.append({"video_id": vid, "category_id": vid, "segmentations": [poly] * 3})
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps({"videos": videos, "annotations": annos,
                                "categories": [{"id": i, "name": str(i)} for i in range(5)]}))
    out = tmp_path / "out"
    args = ovis_run.get_args(["--anno", str(anno), "--video_root", str(tmp_path), "--output_dir",
                              str(out), "--eval_only", "--tracker", "HungarianTracker",
                              "--num_frames", "3", *TINY_FLAGS])
    model = ovis_run.build_model(args)
    line = ovis_run.run_inference(args, model)
    assert line["tracker"] == "HungarianTracker" and line["num_videos"] == 2
    rows = json.loads((out / "results.json").read_text())
    assert rows and {r["video_id"] for r in rows} <= {1, 2}
    for r in rows:
        h = videos[r["video_id"] - 1]["height"]
        assert all(s is None or s["size"][0] == h for s in r["segmentations"])
    from streamformer_tpu_torch.data.seg_datasets import polygons_to_mask

    gt = [{"id": i, "video_id": a["video_id"], "category_id": a["category_id"],
           "segmentations": [ytvis.mask_to_rle(polygons_to_mask(
               s, videos[a["video_id"] - 1]["height"], videos[a["video_id"] - 1]["width"]))
               for s in a["segmentations"]]} for i, a in enumerate(annos)]
    want = jax_ytvis.evaluate_ytvis(rows, gt)
    got = ytvis.evaluate_ytvis(rows, gt)
    assert repr(_plain(got)) == repr(_plain(want))
    assert {k: v for k, v in line.items() if k in got} == {
        k: v for k, v in got.items() if k != "per_class"}
    masks = np.random.default_rng(16).uniform(size=(3, 64, 64)) > 0.5
    for h, w in ((48, 80), (72, 60), (100, 30)):
        want_m = np.stack([cv2.resize(m.astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST)
                           for m in masks]).astype(bool)
        np.testing.assert_array_equal(ovis_run._resize_nearest(masks, h, w), want_m)
