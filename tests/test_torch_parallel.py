"""The port's parallel modules on gloo ranks against the JAX package's
sharded runs: the ring SigLIP loss, the gathered features and the gathered
heads at world 2, 3 and 4; the tensor-parallel encoder (mp=2) with and
without sequence parallelism; the GPipe trunk (pipe 4, and pipe 2 x data
2) against the sequential trunk and JAX ``model_forward_pp``.

The ranks (``tests/_torch_dist_worker.py``, case "parallel") start once for
the module: four processes, one thread each. The JAX oracles run here on
the virtual CPU devices of ``tests/conftest.py``, under ``shard_map`` or on
a mesh. Tolerances: the contrastive terms 1e-5 (the gathered heads'
gradients 1e-5 of their largest magnitude); the tensor-parallel encoder
1e-4 of JAX's sharded forward and gradients (fp32, summation order); the
pipeline within 1e-5 of the sequential port trunk and 1e-4 of JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

import _torch_dist_worker as worker
from streamformer_tpu.config import StreamformerConfig as JaxConfig
from streamformer_tpu.models import encoder as jax_encoder
from streamformer_tpu.models import heads as jax_heads
from streamformer_tpu.parallel import contrastive as jax_contrastive
from streamformer_tpu.parallel import pipeline as jax_pp
from streamformer_tpu.parallel import sharding as jax_sh
from streamformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from streamformer_tpu_torch.checkpoint import params_from_jax
from streamformer_tpu_torch.config import StreamformerConfig
from streamformer_tpu_torch.models import encoder
from streamformer_tpu_torch.parallel import sharding

B, T, D, HP, OUT = 3, 4, 16, 2, 4
SMALL = dict(image_size=32, patch_size=16, num_frames=4, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128, dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tensors are tiny, and the 6-worker run
    oversubscribes the cores with each worker's default thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _jax_params(cfg, key, gate):
    params = jax_encoder.init_params(jax.random.PRNGKey(key), cfg)
    for lp in params["layers"]:
        lp["temporal_attention_gating"] = jnp.asarray(gate)
    return params


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX oracles' trees and every rank's results."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("parallel")
    w = 4
    tree = {"v": {"kernel": 0.3 * _f(rng, D, D), "bias": 0.1 * _f(rng, D)},
            "out": {"kernel": 0.3 * _f(rng, D, D), "bias": 0.1 * _f(rng, D)},
            "layernorm": {"scale": 1 + 0.1 * _f(rng, D), "bias": 0.1 * _f(rng, D)},
            "mlp": {"fc1": {"kernel": 0.3 * _f(rng, D, 2 * D), "bias": 0.1 * _f(rng, 2 * D)},
                    "fc2": {"kernel": 0.3 * _f(rng, 2 * D, D), "bias": 0.1 * _f(rng, D)}}}
    proj = {f"{k}.weight": torch.from_numpy(v["kernel"].T.copy()) for k, v in
            (("v", tree["v"]), ("out", tree["out"]), ("fc1", tree["mlp"]["fc1"]),
             ("fc2", tree["mlp"]["fc2"]))}
    proj.update({f"{k}.bias": torch.from_numpy(v["bias"]) for k, v in
                 (("v", tree["v"]), ("out", tree["out"]), ("fc1", tree["mlp"]["fc1"]),
                  ("fc2", tree["mlp"]["fc2"]))})
    proj["layernorm.weight"] = torch.from_numpy(tree["layernorm"]["scale"])
    proj["layernorm.bias"] = torch.from_numpy(tree["layernorm"]["bias"])
    mask = rng.integers(-1, 2, (w * B, T, OUT, OUT)).astype(np.int64)
    mask[1] = 0  # a sample without a foreground pixel
    arrays = {"img": _unit(_f(rng, w * B, D)), "txt": _unit(_f(rng, w * B, D)),
              "gather_w": _f(rng, w * B, D), "pooler": _f(rng, w * B, T, D),
              "text": _f(rng, w * B, D),
              "frame_labels": rng.integers(0, 2, (w * B, T)).astype(np.float32),
              "last": _f(rng, w * B, T, HP * HP, D), "mask_target": mask}
    inp = {k: torch.from_numpy(v) for k, v in arrays.items()}
    inp.update(per_rank=B, proj=proj)

    jcfg = {"tp": JaxConfig(use_pallas=False, **SMALL),
            "sp": JaxConfig(use_pallas=False, **dict(SMALL, image_size=64))}
    jparams = {"tp": _jax_params(jcfg["tp"], 0, 0.5), "sp": _jax_params(jcfg["sp"], 0, 0.5)}
    jpx = {"tp": _f(rng, 8, 4, 3, 32, 32), "sp": _f(rng, 4, 4, 3, 64, 64)}
    for tag in ("tp", "sp"):
        cfg = StreamformerConfig(**dict(SMALL, image_size=jcfg[tag].image_size))
        inp[f"{tag}_cfg"] = dict(SMALL, image_size=jcfg[tag].image_size)
        inp[f"{tag}_state"] = params_from_jax(jax.tree.map(np.asarray, jparams[tag]), cfg)
        inp[f"{tag}_px"] = torch.from_numpy(jpx[tag])

    pp_kw = dict(SMALL, num_hidden_layers=4)
    pcfg = JaxConfig(use_pallas=False, **pp_kw)
    pparams = _jax_params(pcfg, 0, 0.7)
    ppx = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 4, 3, 32, 32), jnp.float32))
    inp.update(pp_cfg=pp_kw, pp_px=torch.from_numpy(ppx.copy()),
               pp_state=params_from_jax(jax.tree.map(np.asarray, pparams),
                                        StreamformerConfig(**pp_kw)),
               pp_rows=torch.from_numpy(np.tile(_f(rng, 1, 4, 5, 64), (4, 1, 1, 1))))
    torch.save(inp, str(d / "parallel_inputs.pt"))
    ranks = worker.launch("parallel", 4, str(d))
    return {"inp": inp, "arrays": arrays, "tree": tree, "ranks": ranks, "jcfg": jcfg,
            "jparams": jparams, "jpx": jpx, "pcfg": pcfg, "pparams": pparams, "ppx": ppx}


def _mesh(w):
    return Mesh(np.array(jax.devices()[:w]), ("data",))


def _per_shard(fn, w, n_in, replicated=()):
    """``fn`` under shard_map over ``w`` devices: each input split on its
    leading axis except those in ``replicated``; returns each shard's
    scalar."""
    specs = tuple(P() if i in replicated else P("data") for i in range(n_in))
    return jax.jit(shard_map(lambda *a: fn(*a)[None], mesh=_mesh(w), in_specs=specs,
                             out_specs=P("data"), check_vma=False))


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("w", [2, 3, 4])
def test_ring_loss_and_gradients_match_jax(case, w):
    a = case["arrays"]
    img, txt = jnp.asarray(a["img"][:w * B]), jnp.asarray(a["txt"][:w * B])

    def shard_loss(i, t):
        return jax_contrastive.siglip_ring_loss(i, t, jnp.asarray(10.0), jnp.asarray(-2.0), "data")

    f = _per_shard(shard_loss, w, 2)
    losses = f(img, txt)
    g_img, g_txt = jax.jit(jax.grad(lambda i, t: f(i, t).sum(), argnums=(0, 1)))(img, txt)
    for r in range(w):
        loss, gi, gt = case["ranks"][r][f"world{w}"]["ring"]
        rows = slice(r * B, (r + 1) * B)
        _close(loss.item(), losses[r], 1e-5, f"loss, rank {r}")
        _close(gi.numpy(), g_img[rows], 1e-5, f"img gradient, rank {r}")
        _close(gt.numpy(), g_txt[rows], 1e-5, f"txt gradient, rank {r}")
    # the ranks' mean is the global batch's SigLIP loss
    whole = jax_contrastive.siglip_local_loss(img, txt, jnp.asarray(10.0), jnp.asarray(-2.0))
    mean = np.mean([case["ranks"][r][f"world{w}"]["ring"][0].item() for r in range(w)])
    _close(mean, float(whole), 1e-5, "the global loss")


@pytest.mark.parametrize("w", [2, 3, 4])
def test_gathered_features_and_heads_match_jax(case, w):
    a, tree = case["arrays"], case["tree"]
    x, wts = jnp.asarray(a["img"][:w * B]), jnp.asarray(a["gather_w"][:w * B])
    f = _per_shard(lambda v, m: jnp.sum(jax_contrastive.all_gather_features(v, "data") * m), w, 2,
                   replicated=(1,))
    g_x = jax.jit(jax.grad(lambda v: f(v, wts).sum()))(x)
    scale, bias = jnp.asarray(np.log(10.0), jnp.float32), jnp.asarray(-2.0)

    def grounding(p, t, lab, s, b):
        return jax_heads.grounding_contrastive_head(p, t, lab, s, b, axis_name="data")[0]

    fg = _per_shard(grounding, w, 5, replicated=(3, 4))
    pooler, text = jnp.asarray(a["pooler"][:w * B]), jnp.asarray(a["text"][:w * B])
    labels = jnp.asarray(a["frame_labels"][:w * B])
    g_losses = fg(pooler, text, labels, scale, bias)
    g_grads = jax.jit(jax.grad(lambda *v: fg(*v).sum(), argnums=(0, 1, 3, 4)))(
        pooler, text, labels, scale, bias)
    jtree = jax.tree.map(jnp.asarray, tree)

    def refervos(h, t, m, s, b):
        return jax_heads.refervos_contrastive_head(h, jtree, t, m, s, b, axis_name="data")[0]

    fr = _per_shard(refervos, w, 5, replicated=(3, 4))
    last, mask = jnp.asarray(a["last"][:w * B]), jnp.asarray(a["mask_target"][:w * B])
    r_losses = fr(last, text, mask, scale, bias)
    r_grads = jax.jit(jax.grad(lambda *v: fr(*v).sum(), argnums=(0, 1, 3, 4)))(
        last, text, mask, scale, bias)
    def bound(ref):
        return 1e-5 * max(float(np.abs(np.asarray(ref)).max()), 1.0)

    for name, losses, grads in (("grounding", g_losses, g_grads), ("refervos", r_losses, r_grads)):
        for r in range(w):
            got = case["ranks"][r][f"world{w}"]
            rows = slice(r * B, (r + 1) * B)
            assert got["rank"] == r
            _close(got["gather"][0].numpy(), x, 1e-6, "gathered features")
            _close(got["gather"][1].numpy(), g_x[rows], 1e-5, "gather gradient")
            loss, feat_g, text_g, _, _ = got[name]
            _close(loss.item(), losses[r], 1e-5, f"{name} loss, rank {r}")
            _close(feat_g.numpy(), grads[0][rows], bound(grads[0]), f"{name} feature, rank {r}")
            _close(text_g.numpy(), grads[1][rows], bound(grads[1]), f"{name} text, rank {r}")
        # a replicated scalar's gradient: the sum over the ranks of each one's
        for i, what in ((3, "logit_scale"), (4, "logit_bias")):
            total = sum(case["ranks"][r][f"world{w}"][name][i].item() for r in range(w))
            _close(total, grads[i - 1], bound(grads[i - 1]), f"{name} {what}")


def _jax_sharded(tag, case):
    """JAX's pooled output and gradient of sum(pooled ** 2) on a data=2 x
    model=2 mesh (the qkv and MLP leaves sharded over "model")."""
    cfg = case["jcfg"][tag].replace(shard_patches=tag == "sp")
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    px = jnp.asarray(case["jpx"][tag])

    def loss(p, x):
        out = jax_encoder.model_forward(p, x, cfg)["pooler_output"]
        return jnp.sum(out ** 2), out

    with jax.set_mesh(mesh):
        params = jax_sh.shard_params(case["jparams"][tag], mesh)
        (_, pooled), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, px)
    return np.asarray(pooled), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_tensor_parallel_forward_and_gradients_match_jax(case, tag):
    """mp=2 (and with the patch axis sharded too): each data rank's pooled
    rows and every whole gradient, against JAX's sharded forward."""
    pooled, grads = _jax_sharded(tag, case)
    cfg = StreamformerConfig(**case["inp"][f"{tag}_cfg"])
    want = params_from_jax(grads, cfg)  # a linear map: it carries gradients too
    n = pooled.shape[0] // 2
    for r in range(4):
        got = case["ranks"][r][tag]
        d = got["data_rank"]
        _close(got["pooler"].numpy(), pooled[d * n:(d + 1) * n], 1e-4, f"pooled, rank {r}")
    assert set(case["ranks"][0][tag]["grads"]) == set(want)
    for name, g in case["ranks"][0][tag]["grads"].items():
        ref = want[name].numpy()
        bound = 1e-4 * max(float(np.abs(ref).max()), 1e-3)
        _close(g.numpy(), ref, bound, name)
    # every rank holds the same whole gradients
    for r in range(1, 4):
        for name, g in case["ranks"][r][tag]["grads"].items():
            assert torch.equal(g, case["ranks"][0][tag]["grads"][name]), (r, name)


def test_qkv_is_sharded_by_heads(case):
    """Rank r of the model group holds [q, k, v] of heads 2r and 2r+1 of the
    fused qkv, in that order, and the pieces rebuild the whole tensor."""
    full = case["inp"]["tp_state"]["encoder.layer.0.attention.attention.qkv.weight"]
    d, dh = SMALL["hidden_size"], SMALL["hidden_size"] // SMALL["num_attention_heads"]
    pieces = {}
    for res in case["ranks"]:
        r = res["tp"]["model_rank"]
        heads = slice(2 * r * dh, (2 * r + 2) * dh)
        want = torch.cat([full[i * d:(i + 1) * d][heads] for i in range(3)])
        assert torch.equal(res["tp"]["qkv"], want)
        pieces[r] = res["tp"]["qkv"]
    assert torch.equal(sharding.unshard([pieces[0], pieces[1]], sharding.Shard(0, 3)), full)
    rule = sharding.Shard(1)
    w = torch.randn(6, 8)
    assert torch.equal(sharding.unshard([sharding.shard_of(w, rule, 2, r) for r in range(2)],
                                        rule), w)


@pytest.mark.parametrize("pipe", [4, 2])
def test_pipeline_matches_the_sequential_trunk_and_jax(case, pipe):
    """GPipe over 4 stages (data 1) and over 2 (data 2), 2 microbatches:
    forward and every gradient against the one-process port and JAX
    ``model_forward_pp`` on the same split."""
    inp = case["inp"]
    cfg = StreamformerConfig(**inp["pp_cfg"])
    model = encoder.StreamformerEncoder(cfg, device="cpu", trainable=True)
    model.load_state_dict(inp["pp_state"])
    out = encoder.model_forward(model, inp["pp_px"])
    (out["pooler_output"] ** 2).sum().backward()
    mesh = jax_pp.make_pipeline_mesh(data=4 // pipe, pipe=pipe, devices=jax.devices()[:4])
    px = jnp.asarray(case["ppx"])

    def loss(p):
        o = jax_pp.model_forward_pp(p, px, case["pcfg"], mesh=mesh, num_microbatches=2)
        return jnp.sum(o["pooler_output"] ** 2), o["pooler_output"]

    with mesh:
        (_, jpooled), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(case["pparams"])
    jwant = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    data = 4 // pipe
    n = inp["pp_px"].shape[0] // data
    for r, res in enumerate(case["ranks"]):
        got = res[f"pp{pipe}"]
        rows = slice(got["data_rank"] * n, (got["data_rank"] + 1) * n)
        _close(got["pooler"].numpy(), out["pooler_output"][rows].detach().numpy(), 1e-5,
               f"pooled, rank {r}")
        _close(got["last"].numpy(), out["last_hidden_state"][rows].detach().numpy(), 1e-5,
               f"hidden, rank {r}")
        _close(got["pooler"].numpy(), np.asarray(jpooled)[rows], 1e-4, f"JAX pooled, rank {r}")
        stage = r % pipe
        per = cfg.num_hidden_layers // pipe
        held = {f"encoder.layer.{i}." for i in range(stage * per, (stage + 1) * per)}
        for name, p in model.named_parameters():
            if name.startswith("encoder.layer.") and not any(name.startswith(h) for h in held):
                assert name not in got["grads"], name  # another stage's layer is freed here
                continue
            ref = p.grad.numpy()
            bound = max(float(np.abs(ref).max()), 1e-3)
            _close(got["grads"][name].numpy(), ref, 1e-5 * bound, f"{name}, rank {r}")
            _close(got["grads"][name].numpy(), jwant[name].numpy(), 1e-4 * bound,
                   f"{name} against JAX, rank {r}")


def test_pipeline_dropout_is_the_sequential_trunks_and_decorrelated(case):
    """Four equal rows in two microbatches: with dropout and stochastic
    depth on, the pipeline draws each row's masks of the sequential trunk,
    so rows in different microbatches differ."""
    for res in case["ranks"]:
        got, want = res["pp_dropout"]["got"], res["pp_dropout"]["want"]
        _close(got.numpy(), want.numpy(), 1e-5, "pipelined against sequential")
        assert not torch.allclose(got[0], got[2]) and not torch.allclose(got[1], got[3])
        assert not torch.allclose(got[0], got[1])


def test_pipeline_refuses_an_uneven_split_and_sequence_parallelism():
    from streamformer_tpu_torch.parallel import pipeline

    model = encoder.StreamformerEncoder(StreamformerConfig(**dict(SMALL, num_hidden_layers=4)),
                                        device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stack_pipeline_params(model, 3)
    stages, per = pipeline.stack_pipeline_params(model, 2)
    assert per == 2 and [s.first for s in stages] == [0, 2]
    assert stages[1].layers[0] is model.encoder.layer[2]
