"""The zoo's weight converters in the port (ROADMAP A13 part 6) against
the JAX package's, on the CPU: each of the eight on the seeded manifests
of tests/test_zoo_import.py gives a tree equal to JAX's bit for bit, with
equal leftovers; the port backbone loaded from it
(``zoo_import.converted_backbone_state``) matches the JAX backbone
applied with JAX's converted variables, at a reduced depth and width, in
float64 on both sides, within 1e-9 of the largest output; and ``cli.
convert model`` round-trips through its file."""

import os

import numpy as np
import pytest
import torch

import jax

from peanut_tpu.models import zoo_import as jzoo
from peanut_tpu_torch.cli import convert
from peanut_tpu_torch.models import zoo_import
from peanut_tpu_torch.models.mmseg_import import load_mmseg_state

from test_zoo_import import (_official_stdc_sd_shapes, _official_swin_sd,
                             convnext_tiny_manifest, mit_b0_manifest,
                             timm_vit_manifest)
from torch_zoo_support import (NARROW_CONVNEXT, jax64,  # noqa: F401
                               narrow_convnext, one_thread, rel_err)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


def _rand(shapes, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s) * scale if s else np.zeros(()) for k, s in
            shapes.items()}


def vit_sd(seed=0):
    return _rand(timm_vit_manifest(8, 2), seed, 0.3)


def augreg_npz(seed=0, d=8, heads=2, dh=4, depth=2):
    rng = np.random.RandomState(seed)
    npz = {"embedding/kernel": rng.randn(16, 16, 3, d) * 0.1,
           "embedding/bias": rng.randn(d) * 0.1,
           "Transformer/posembed_input/pos_embedding":
               rng.randn(1, 197, d) * 0.1}
    for i in range(depth):
        t = f"Transformer/encoderblock_{i}"
        a = f"{t}/MultiHeadDotProductAttention_1"
        for nm in ("query", "key", "value"):
            npz[f"{a}/{nm}/kernel"] = rng.randn(d, heads, dh) * 0.3
            npz[f"{a}/{nm}/bias"] = rng.randn(heads, dh) * 0.1
        npz[f"{a}/out/kernel"] = rng.randn(heads, dh, d) * 0.3
        npz[f"{a}/out/bias"] = rng.randn(d) * 0.1
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[f"{t}/{ln}/scale"] = 1.0 + rng.randn(d) * 0.1
            npz[f"{t}/{ln}/bias"] = rng.randn(d) * 0.1
        npz[f"{t}/MlpBlock_3/Dense_0/kernel"] = rng.randn(d, 4 * d) * 0.3
        npz[f"{t}/MlpBlock_3/Dense_0/bias"] = rng.randn(4 * d) * 0.1
        npz[f"{t}/MlpBlock_3/Dense_1/kernel"] = rng.randn(4 * d, d) * 0.2
        npz[f"{t}/MlpBlock_3/Dense_1/bias"] = rng.randn(d) * 0.1
    return npz


def swin_sd(seed=0):
    """tests/test_zoo_import.py's one-block official Swin, in float64,
    with a stage norm (``norm0``, mmseg's per-stage output norm), so the
    tree covers the whole one-stage backbone."""
    rng = np.random.RandomState(seed)
    sd = {k: v.astype(np.float64) * 0.3 if v.dtype != np.int64 else v
          for k, v in _official_swin_sd(rng).items()}
    sd["norm0.weight"] = 1.0 + rng.randn(8) * 0.1
    sd["norm0.bias"] = rng.randn(8) * 0.1
    return sd


def convnext_manifest(depths, dims):
    """tests/test_zoo_import.py's mmcls ConvNeXt key set at any depths
    and widths."""
    sd = {}
    in_c = 3
    for i, (nd, d) in enumerate(zip(depths, dims)):
        t = f"backbone.downsample_layers.{i}"
        k = 4 if i == 0 else 2
        conv_idx, norm_idx = (0, 1) if i == 0 else (1, 0)
        sd[f"{t}.{conv_idx}.weight"] = (d, in_c, k, k)
        sd[f"{t}.{conv_idx}.bias"] = (d,)
        sd[f"{t}.{norm_idx}.weight"] = (in_c,) if i else (d,)
        sd[f"{t}.{norm_idx}.bias"] = sd[f"{t}.{norm_idx}.weight"]
        for j in range(nd):
            t2 = f"backbone.stages.{i}.{j}"
            sd[f"{t2}.depthwise_conv.weight"] = (d, 1, 7, 7)
            sd[f"{t2}.depthwise_conv.bias"] = (d,)
            sd[f"{t2}.norm.weight"] = (d,)
            sd[f"{t2}.norm.bias"] = (d,)
            sd[f"{t2}.pointwise_conv1.weight"] = (4 * d, d)
            sd[f"{t2}.pointwise_conv1.bias"] = (4 * d,)
            sd[f"{t2}.pointwise_conv2.weight"] = (d, 4 * d)
            sd[f"{t2}.pointwise_conv2.bias"] = (d,)
            sd[f"{t2}.gamma"] = (d,)
        sd[f"backbone.norm{i}.weight"] = (d,)
        sd[f"backbone.norm{i}.bias"] = (d,)
        in_c = d
    return sd


def beit_shapes(d=8, heads=2, depth=2, patch=4, img=16):
    g = img // patch
    shapes = {"patch_embed.proj.weight": (d, 3, patch, patch),
              "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d)}
    for i in range(depth):
        t = f"blocks.{i}"
        shapes.update({
            f"{t}.norm1.weight": (d,), f"{t}.norm1.bias": (d,),
            f"{t}.norm2.weight": (d,), f"{t}.norm2.bias": (d,),
            f"{t}.attn.qkv.weight": (3 * d, d),
            f"{t}.attn.q_bias": (d,), f"{t}.attn.v_bias": (d,),
            f"{t}.attn.proj.weight": (d, d), f"{t}.attn.proj.bias": (d,),
            f"{t}.mlp.fc1.weight": (4 * d, d), f"{t}.mlp.fc1.bias": (4 * d,),
            f"{t}.mlp.fc2.weight": (d, 4 * d), f"{t}.mlp.fc2.bias": (d,),
            f"{t}.gamma_1": (d,), f"{t}.gamma_2": (d,),
            f"{t}.attn.relative_position_bias_table":
                ((2 * g - 1) ** 2 + 3, heads),
            f"{t}.attn.relative_position_index": (g * g + 1, g * g + 1)})
    return shapes


def stdc_sd(seed=0):
    sd = _rand(_official_stdc_sd_shapes((8, 8, 16, 32, 64)), seed, 0.3)
    sd["fc.weight"] = np.zeros((10, 64))               # a classifier key
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 1.0
    return sd


def twins_shapes(dims=(8, 16), depths=(1, 2), srs=(2, 1), mlps=(2, 2)):
    shapes = {"norm.weight": (dims[-1],), "norm.bias": (dims[-1],),
              "head.weight": (10, dims[-1])}
    for s, d in enumerate(dims):
        patch = 4 if s == 0 else 2
        cin = 3 if s == 0 else dims[s - 1]
        shapes.update({
            f"patch_embeds.{s}.proj.weight": (d, cin, patch, patch),
            f"patch_embeds.{s}.proj.bias": (d,),
            f"patch_embeds.{s}.norm.weight": (d,),
            f"patch_embeds.{s}.norm.bias": (d,),
            f"pos_block.{s}.proj.0.weight": (d, 1, 3, 3),
            f"pos_block.{s}.proj.0.bias": (d,)})
        for j in range(depths[s]):
            t = f"blocks.{s}.{j}"
            shapes.update({
                f"{t}.norm1.weight": (d,), f"{t}.norm1.bias": (d,),
                f"{t}.norm2.weight": (d,), f"{t}.norm2.bias": (d,),
                f"{t}.attn.q.weight": (d, d), f"{t}.attn.q.bias": (d,),
                f"{t}.attn.kv.weight": (2 * d, d),
                f"{t}.attn.kv.bias": (2 * d,),
                f"{t}.attn.proj.weight": (d, d),
                f"{t}.attn.proj.bias": (d,),
                f"{t}.mlp.fc1.weight": (mlps[s] * d, d),
                f"{t}.mlp.fc1.bias": (mlps[s] * d,),
                f"{t}.mlp.fc2.weight": (d, mlps[s] * d),
                f"{t}.mlp.fc2.bias": (d,)})
            if srs[s] > 1:
                shapes.update({
                    f"{t}.attn.sr.weight": (d, d, srs[s], srs[s]),
                    f"{t}.attn.sr.bias": (d,),
                    f"{t}.attn.norm.weight": (d,),
                    f"{t}.attn.norm.bias": (d,)})
    return shapes


def svt_shapes(d=8):
    """An SVT stage: an LSA block (fused qkv) then a GSA one (sr 1)."""
    shapes = {"patch_embeds.0.proj.weight": (d, 3, 4, 4),
              "patch_embeds.0.proj.bias": (d,),
              "patch_embeds.0.norm.weight": (d,),
              "patch_embeds.0.norm.bias": (d,),
              "pos_block.0.proj.0.weight": (d, 1, 3, 3),
              "pos_block.0.proj.0.bias": (d,)}
    for j, lsa in ((0, True), (1, False)):
        t = f"blocks.0.{j}"
        shapes.update({
            f"{t}.norm1.weight": (d,), f"{t}.norm1.bias": (d,),
            f"{t}.norm2.weight": (d,), f"{t}.norm2.bias": (d,),
            f"{t}.attn.proj.weight": (d, d), f"{t}.attn.proj.bias": (d,),
            f"{t}.mlp.fc1.weight": (2 * d, d), f"{t}.mlp.fc1.bias": (2 * d,),
            f"{t}.mlp.fc2.weight": (d, 2 * d), f"{t}.mlp.fc2.bias": (d,)})
        if lsa:
            shapes.update({f"{t}.attn.qkv.weight": (3 * d, d),
                           f"{t}.attn.qkv.bias": (3 * d,)})
        else:
            shapes.update({f"{t}.attn.q.weight": (d, d),
                           f"{t}.attn.q.bias": (d,),
                           f"{t}.attn.kv.weight": (2 * d, d),
                           f"{t}.attn.kv.bias": (2 * d,)})
    return shapes


def _norms_positive(sd):
    """Norm scales near 1 (random ones near 0 would flatten the features
    that the comparison reads)."""
    return {k: 1.0 + v if k.endswith(".weight")
            and "norm" in k.rsplit(".", 2)[-2] else v
            for k, v in sd.items()}


# converter, its inputs, the leftovers JAX's tests accept, and the
# backbone (JAX module path, port module path, kwargs) at a small size
CASES = {
    "vit": (lambda: jzoo.convert_timm_vit, lambda: zoo_import.convert_timm_vit,
            lambda: _norms_positive(vit_sd()),
            ["cls_token", "norm.weight", "norm.bias"],
            ("vit", "VisionTransformer",
             dict(embed_dim=8, depth=2, num_heads=2, out_indices=(0, 1))),
            (32, 32)),
    "vitjax": (lambda: jzoo.convert_augreg_vit,
               lambda: zoo_import.convert_augreg_vit, augreg_npz, [],
               ("vit", "VisionTransformer",
                dict(embed_dim=8, depth=2, num_heads=2, out_indices=(0, 1))),
               (32, 32)),
    "mit": (lambda: jzoo.convert_official_mit,
            lambda: zoo_import.convert_official_mit,
            lambda: _norms_positive(_rand(mit_b0_manifest(), 1, 0.1)), [],
            ("mit", "MITB0", {}), (64, 64)),
    "swin": (lambda: jzoo.convert_official_swin,
             lambda: zoo_import.convert_official_swin,
             lambda: _norms_positive(swin_sd()), [],
             ("vit", "SwinTransformer",
              dict(embed_dim=8, depths=(1,), num_heads=(2,))), (16, 16)),
    "convnext": (lambda: jzoo.convert_mmcls_convnext,
                 lambda: zoo_import.convert_mmcls_convnext,
                 lambda: _norms_positive(_rand(convnext_manifest(
                     *NARROW_CONVNEXT), 2, 0.2)), [],
                 ("convnext", "ConvNeXt", dict(arch="narrow")), (64, 64)),
    "beit": (lambda: jzoo.convert_official_beit,
             lambda: zoo_import.convert_official_beit,
             lambda: _norms_positive(_rand(beit_shapes(), 3, 0.3)),
             ["cls_token"],
             ("backbones_zoo", "BEiT",
              dict(embed_dim=8, depth=2, num_heads=2, patch_size=4,
                   out_indices=(0, 1))), (16, 16)),
    "stdc1": (lambda: lambda sd: jzoo.convert_official_stdc(sd, "STDCNet1"),
              lambda: lambda sd: zoo_import.convert_official_stdc(
                  sd, "STDCNet1"),
              stdc_sd, ["fc.weight"],
              ("backbones_zoo", "STDCNet",
               dict(channels=(8, 8, 16, 32, 64))), (64, 64)),
    "twins": (lambda: jzoo.convert_official_twins,
              lambda: zoo_import.convert_official_twins,
              lambda: _norms_positive(_rand(twins_shapes(), 4, 0.3)),
              ["norm.weight", "norm.bias"],
              ("backbones_zoo", "PCPVT",
               dict(embed_dims=(8, 16), num_heads=(2, 2), depths=(1, 2),
                    sr_ratios=(2, 1), mlp_ratios=(2, 2),
                    out_indices=(0, 1))), (32, 32)),
    "twins_svt": (lambda: jzoo.convert_official_twins,
                  lambda: zoo_import.convert_official_twins,
                  lambda: _norms_positive(_rand(svt_shapes(), 5, 0.3)), [],
                  ("backbones_zoo", "PCPVT",
                   dict(embed_dims=(8,), num_heads=(2,), depths=(2,),
                        sr_ratios=(1,), mlp_ratios=(2,), windows=(3,),
                        out_indices=(0,))), (16, 16)),
}


def _backbones(spec):
    import importlib
    mod, cls, kw = spec
    jm = getattr(importlib.import_module(f"peanut_tpu.models.{mod}"), cls)
    tm = getattr(importlib.import_module(f"peanut_tpu_torch.models.{mod}"),
                 cls)
    return jm(**kw), tm(**kw)


def _complete(converted, jmod, hw, seed=6):
    """The converted tree completed by seeded values for what the
    checkpoint lacks (official Twins' per-stage output norms), as a JAX
    caller merges it into its initial variables: the same tree for both
    packages."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), np.zeros((1, *hw, 3), np.float32)))
    rng = np.random.RandomState(seed)
    out = {c: dict(t) for c, t in converted.items()}
    for col, tree in shapes.items():
        have = _flat(out.get(col, {}))
        for path, s in _flat(tree).items():
            if path not in have:
                node = out.setdefault(col, {})
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = (1.0 if path[-1] == "scale" else 0.0) + \
                    0.1 * rng.randn(*s.shape)
    return out


@pytest.mark.parametrize("kind", sorted(CASES))
def test_converter_matches_jax_and_loads_into_the_backbone(kind,
                                                           narrow_convnext):
    jfn, tfn, make, accepted, spec, hw = CASES[kind]
    sd = make()
    want, want_left = jfn()(sd)
    got, left = tfn()(sd)
    assert_trees_equal(got, want)
    assert left == want_left
    assert set(left) <= set(accepted), left

    jm, tm = _backbones(spec)
    tm = tm.to(torch.float64)
    if kind.startswith("twins"):
        # official Twins has no per-stage output norms: the loader names
        # what is left unset ...
        with pytest.raises(KeyError, match="out_norm"):
            zoo_import.converted_backbone_state(got, tm)
        # ... keeps the backbone's own where told to ...
        kept = zoo_import.converted_backbone_state(
            got, tm, keep=(r"out_norm\d+\..*",))
        own = tm.state_dict()
        assert sorted(kept) == sorted(own)
        for n in own:
            if n.startswith("out_norm"):
                np.testing.assert_array_equal(kept[n], own[n].numpy())
        # ... and takes the tree once the caller completes it
        got = _complete(got, jm, hw)
    load_mmseg_state(tm, zoo_import.converted_backbone_state(got, tm)).eval()
    x = np.random.RandomState(7).rand(1, *hw, 3)
    outs = jax64(jm, got, x)
    with torch.no_grad():
        mine = tm(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert len(mine) == len(outs) > 0
    for a, b in zip(mine, outs):
        assert a.dtype == torch.float64
        assert rel_err(a.permute(0, 2, 3, 1).numpy(), b) <= 1e-9


def test_the_loader_raises_on_an_array_it_cannot_place():
    from peanut_tpu_torch.models.vit import VisionTransformer
    got, _ = zoo_import.convert_timm_vit(vit_sd())
    got["params"]["block0"]["attn"]["extra"] = {"kernel": np.zeros((8, 8))}
    with pytest.raises(KeyError, match="block0/attn/extra"):
        zoo_import.converted_backbone_state(
            got, VisionTransformer(embed_dim=8, depth=2, num_heads=2,
                                   out_indices=(0, 1)))


def test_full_width_convnext_t_tree_equals_jax():
    """The reference configs' mmcls ConvNeXt-T (dims 96-768, depths
    3/3/9/3), converted by both packages, and laid into the port's
    ConvNeXt-T without a parameter left over or unset."""
    from peanut_tpu_torch.models.convnext import ConvNeXt
    sd = _rand(convnext_tiny_manifest(), 8, 0.05)
    want, want_left = jzoo.convert_mmcls_convnext(sd)
    got, left = zoo_import.convert_mmcls_convnext(sd)
    assert_trees_equal(got, want)
    assert left == want_left == []
    state = zoo_import.converted_backbone_state(got, ConvNeXt())
    assert len(state) == len(_flat(got)) == 186


def _save_source(kind, sd, path):
    if kind == "vitjax":
        np.savez(path, **{k: v.astype(np.float32) for k, v in sd.items()})
    else:
        torch.save({"state_dict": {
            k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
            sd.items()}}, path)


@pytest.mark.parametrize("kind", ["vit", "vitjax", "mit", "swin",
                                  "convnext", "beit", "stdc1", "stdc2",
                                  "twins"])
def test_convert_cli_round_trips_through_its_file(kind, tmp_path, capsys):
    """``cli.convert model KIND SRC OUT``: the file holds JAX's tree of
    the checkpoint (read as the JAX package reads it, float32), and the
    CLI prints the array count and the unmapped keys."""
    from peanut_tpu.core.checkpoint import load_torch_state_dict
    if kind == "stdc2":
        sd = _rand(_official_stdc_sd_shapes((8, 8, 16, 32, 64),
                                            stdc1=False), 9, 0.3)
    else:
        sd = CASES[kind][2]()
    src = str(tmp_path / ("src.npz" if kind == "vitjax" else "src.pth"))
    _save_source(kind, sd, src)
    out = str(tmp_path / "out.pt")
    convert.main(["model", kind, src, out])
    printed = capsys.readouterr().out
    if kind == "vitjax":
        want, left = jzoo.convert_augreg_vit(dict(np.load(src)))
    elif kind in ("stdc1", "stdc2"):
        want, left = jzoo.convert_official_stdc(
            load_torch_state_dict(src),
            "STDCNet1" if kind == "stdc1" else "STDCNet2")
    else:
        want, left = {"vit": jzoo.convert_timm_vit,
                      "mit": jzoo.convert_official_mit,
                      "swin": jzoo.convert_official_swin,
                      "convnext": jzoo.convert_mmcls_convnext,
                      "beit": jzoo.convert_official_beit,
                      "twins": jzoo.convert_official_twins}[kind](
            load_torch_state_dict(src))
    assert_trees_equal(convert.load_converted(out), want)
    lines = printed.splitlines()
    assert lines[0] == (f"converted {kind}: {len(_flat(want))} arrays -> "
                        f"{out}")
    if left:
        assert lines[1] == f"unmapped source keys ({len(left)}):"
        assert [ln.strip() for ln in lines[2:]] == left[:20]
    else:
        assert len(lines) == 1
    assert os.path.getsize(out) > 0
