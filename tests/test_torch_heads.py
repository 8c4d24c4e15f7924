"""Every head of the port against the JAX package's, on the CPU in fp32:
loss, logits and the gradients with respect to the features, ``logit_scale``
and ``logit_bias``; and the stop-gradients.

Tolerance 1e-4 max-abs on losses and logits (the runs reach
about 1e-5), and 1e-4 of each gradient's largest magnitude on gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamformer_tpu.models import heads as jax_heads
from streamformer_tpu_torch.models import heads
from streamformer_tpu_torch.parallel import contrastive

B, T, D, L, HP, OUT = 3, 4, 16, 5, 3, 8
ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _proj_params(rng):
    """The MAP head's V, out, LN and MLP as a JAX tree, and the same as the
    port's projection dict."""
    def dense(i, o):
        return {"kernel": 0.3 * _f(rng, i, o), "bias": 0.1 * _f(rng, o)}

    tree = {"v": dense(D, D), "out": dense(D, D),
            "layernorm": {"scale": 1 + 0.1 * _f(rng, D), "bias": 0.1 * _f(rng, D)},
            "mlp": {"fc1": dense(D, 2 * D), "fc2": dense(2 * D, D)}}
    port = {}
    for name, p in (("v", tree["v"]), ("out", tree["out"]), ("fc1", tree["mlp"]["fc1"]),
                    ("fc2", tree["mlp"]["fc2"])):
        port[name + ".weight"] = torch.from_numpy(p["kernel"].T.copy())
        port[name + ".bias"] = torch.from_numpy(p["bias"])
    port["layernorm.weight"] = torch.from_numpy(tree["layernorm"]["scale"])
    port["layernorm.bias"] = torch.from_numpy(tree["layernorm"]["bias"])
    return tree, port


def _case(name):
    """(jax head, port head, differentiable feature, other args before the
    scale and bias, other args after them) for one head, from a seed."""
    rng = _rng(sum(map(ord, name)))
    pooler = _f(rng, B, T, D)
    hidden = _f(rng, B, T, HP * HP, D)
    text = _f(rng, B, D)
    frame01 = rng.integers(0, 2, (B, T)).astype(np.float32)
    mask_cls = rng.integers(-1, L, (B, T, OUT, OUT)).astype(np.int32)
    class_mask = np.ones((B, L), bool)
    class_mask[0, -1] = False
    mask_cls[0][mask_cls[0] == L - 1] = 0  # a labelled pixel never selects a masked class
    tree, port = _proj_params(rng)
    if name == "classification":
        return (jax_heads.classification_head, heads.classification_head, pooler,
                [_unit(_f(rng, L, D)), rng.integers(0, L, B).astype(np.int32)], [], None)
    if name == "retrieval":
        return jax_heads.retrieval_head, heads.retrieval_head, pooler, [text], [], None
    if name == "grounding":
        return jax_heads.grounding_head, heads.grounding_head, pooler, [text, frame01], [], None
    if name == "grounding_contrastive":
        return (jax_heads.grounding_contrastive_head, heads.grounding_contrastive_head, pooler,
                [text, frame01], [], None)
    if name == "naive_localization":
        windows = 2  # two videos of two windows: (2*W, T, D) regrouped to (2, W*T, D)
        feats = _f(rng, 2 * windows, T, D)
        targets = rng.integers(-1, 2, (2, windows * T, L)).astype(np.float32)
        return (jax_heads.naive_localization_head, heads.naive_localization_head, feats,
                [_f(rng, L, D), targets], [], None)
    if name == "universal_localization":
        return (jax_heads.universal_localization_head, heads.universal_localization_head, pooler,
                [_unit(_f(rng, B, L, D)), class_mask, rng.integers(-1, L, (B, T)).astype(np.int32)],
                [], None)
    if name == "vis":
        return (jax_heads.vis_segmentation_head, heads.vis_segmentation_head, hidden,
                [(tree, port), _unit(_f(rng, B, L, D)), class_mask, mask_cls], [], None)
    if name == "refervos":
        mask01 = rng.integers(-1, 2, (B, T, OUT, OUT)).astype(np.int32)
        mask01[1] = 0  # a sample without a foreground pixel contributes 0
        return (jax_heads.refervos_contrastive_head, heads.refervos_contrastive_head, hidden,
                [(tree, port), text, mask01], [], None)
    raise KeyError(name)


HEADS = ["classification", "retrieval", "grounding", "grounding_contrastive", "naive_localization",
         "universal_localization", "vis", "refervos"]


def _args(args, side):
    out = []
    for a in args:
        if isinstance(a, tuple):
            out.append(jax.tree.map(jnp.asarray, a[0]) if side == "jax" else a[1])
        else:
            out.append(jnp.asarray(a) if side == "jax" else torch.from_numpy(a))
    return out


@pytest.mark.parametrize("name", HEADS)
def test_head_loss_logits_and_gradients_match_jax(name):
    jax_head, port_head, feat, args, _, _ = _case(name)
    scale0, bias0 = np.float32(np.log(10.0)), np.float32(-2.0)
    kw = {"axis_name": None} if name in ("retrieval", "grounding_contrastive", "refervos") else {}

    def jax_loss(f, s, b):
        return jax_head(f, *_args(args, "jax"), s, b, **kw)

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                           has_aux=True)(
        jnp.asarray(feat), jnp.asarray(scale0), jnp.asarray(bias0))
    f = torch.from_numpy(feat).requires_grad_()
    s = torch.tensor(float(scale0), requires_grad=True)
    b = torch.tensor(float(bias0), requires_grad=True)
    loss, logits = port_head(f, *_args(args, "torch"), s, b)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL, rtol=0)
    assert tuple(logits.shape) == tuple(ref_logits.shape)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    grads = torch.autograd.grad(loss, (f, s, b))
    for what, got, ref in zip(("feature", "logit_scale", "logit_bias"), grads, ref_grads):
        ref = np.asarray(ref)
        bound = ATOL * max(float(np.abs(ref).max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), ref, atol=bound, rtol=0, err_msg=what)


def test_classification_linear_head_matches_jax():
    rng = _rng(7)
    pooler, labels = _f(rng, B, T, D), rng.integers(0, L, B).astype(np.int32)
    params = {"kernel": 0.3 * _f(rng, D, L), "bias": 0.1 * _f(rng, L)}

    def jax_loss(f, p):
        return jax_heads.classification_linear_head(f, p, jnp.asarray(labels))

    (ref_loss, ref_logits), (ref_gf, ref_gp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(pooler),
                                                jax.tree.map(jnp.asarray, params))
    f = torch.from_numpy(pooler).requires_grad_()
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    loss, logits = heads.classification_linear_head(f, p, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)
    gf, gk, gb = torch.autograd.grad(loss, (f, p["kernel"], p["bias"]))
    np.testing.assert_allclose(gf.numpy(), np.asarray(ref_gf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(ref_gp["kernel"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(ref_gp["bias"]), atol=1e-5, rtol=0)


def test_label_embeddings_receive_no_gradient():
    """The class anchors are detached (the JAX package's stop_gradient)."""
    rng = _rng(8)
    pooler = torch.from_numpy(_f(rng, B, T, D)).requires_grad_()
    table = torch.from_numpy(_unit(_f(rng, L, D))).requires_grad_()
    loss, _ = heads.classification_head(pooler, table, torch.tensor([0, 1, 2]),
                                        torch.tensor(2.3), torch.tensor(-2.0))
    g_pool, g_table = torch.autograd.grad(loss, (pooler, table), allow_unused=True)
    assert g_table is None and float(g_pool.abs().max()) > 0


def test_dense_projection_is_frozen_and_matches_jax():
    """``dense_projection_params`` detaches the MAP head's tensors (exactly
    zero gradient into the head), and the projection equals the JAX one."""
    from streamformer_tpu_torch.config import StreamformerConfig
    from streamformer_tpu_torch.models.encoder import StreamformerEncoder

    cfg = StreamformerConfig(image_size=32, num_frames=2, hidden_size=D, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=2 * D, dtype="float32")
    enc = StreamformerEncoder(cfg, device="cpu", trainable=True,
                              generator=torch.Generator().manual_seed(0))
    proj = heads.dense_projection_params(enc.head)
    assert all(not v.requires_grad for v in proj.values())
    assert torch.equal(proj["v.weight"], enc.head.attention.in_proj_weight[2 * D:].detach())
    x = torch.from_numpy(_f(_rng(9), 2, 2, 4, D)).requires_grad_()
    heads.dense_feature_projection(x, proj).sum().backward()
    assert all(p.grad is None for p in enc.head.parameters()) and x.grad is not None
    tree, port = _proj_params(_rng(10))
    ref = jax_heads.dense_feature_projection(jnp.asarray(x.detach().numpy()),
                                             jax.tree.map(jnp.asarray, tree))
    got = heads.dense_feature_projection(x.detach(), port)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size,note", [((8, 8), "enlarging"), ((7, 11), "enlarging, odd"),
                                       ((2, 2), "shrinking: antialiased as jax.image.resize")])
def test_bilinear_resize_matches_jax(size, note):
    x = _f(_rng(11), 2, HP + 1, HP + 1, L)
    ref = jax_heads._bilinear_resize_logits(jnp.asarray(x), *size)
    got = heads._bilinear_resize_logits(torch.from_numpy(x), *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0, err_msg=note)


def test_vis_head_ignores_unlabelled_samples_and_masked_classes():
    rng = _rng(12)
    tree, port = _proj_params(rng)
    hidden = torch.from_numpy(_f(rng, 2, T, HP * HP, D)).requires_grad_()
    table = torch.from_numpy(_unit(_f(rng, 2, L, D)))
    class_mask = torch.ones(2, L, dtype=torch.bool)
    class_mask[:, -1] = False
    target = torch.from_numpy(rng.integers(0, L - 1, (2, T, OUT, OUT)).astype(np.int64))
    target[1] = -1  # the second sample has no labelled pixel
    loss, _ = heads.vis_segmentation_head(hidden, port, table, class_mask, target,
                                          torch.tensor(2.3), torch.tensor(-2.0))
    (grad,) = torch.autograd.grad(loss, hidden)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert float(grad[1].abs().max()) == 0.0 and float(grad[0].abs().max()) > 0


def test_single_process_forms_and_the_refused_group():
    """The single-process forms against JAX's, and the same forms over a
    process group of one rank (gloo, in this process): a group is no longer
    refused; its multi-rank forms are tests/test_torch_parallel.py's."""
    rng = _rng(13)
    img, txt = (torch.from_numpy(_unit(_f(rng, 4, D))) for _ in range(2))
    scale, bias = torch.tensor(10.0), torch.tensor(-2.0)
    ref = jax_heads.siglip_ring_loss(jnp.asarray(img.numpy()), jnp.asarray(txt.numpy()),
                                     jnp.asarray(10.0), jnp.asarray(-2.0), None)
    got = contrastive.siglip_ring_loss(img, txt, scale, bias)
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=0)
    neg = contrastive.siglip_local_loss(img, txt[:3], scale, bias, negative_only=True)
    from streamformer_tpu.parallel import contrastive as jax_contrastive

    ref_neg = jax_contrastive.siglip_local_loss(jnp.asarray(img.numpy()),
                                                jnp.asarray(txt[:3].numpy()), jnp.asarray(10.0),
                                                jnp.asarray(-2.0), negative_only=True)
    np.testing.assert_allclose(neg.item(), float(ref_neg), atol=1e-5, rtol=0)
    assert contrastive.all_gather_features(img) is img and contrastive.axis_rank() == 0
    import torch.distributed as dist

    from _torch_dist_worker import free_port

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        assert contrastive.siglip_ring_loss(img, txt, scale, bias, group).item() == got.item()
        assert contrastive.all_gather_features(img, group) is img
        assert contrastive.axis_rank(group) == 0
        pooler = torch.from_numpy(_f(rng, 4, T, D))
        labels = torch.from_numpy(rng.integers(0, 2, (4, T)).astype(np.float32))
        alone = heads.grounding_contrastive_head(pooler, txt, labels, scale, bias)[0]
        assert heads.grounding_contrastive_head(pooler, txt, labels, scale, bias,
                                                group=group)[0].item() == alone.item()
    finally:
        dist.destroy_process_group()
