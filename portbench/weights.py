"""Seeded inputs that both the program and the plain reference take: the
HuMoR and VPoser weights, the initial-state GMM and the synthetic SMPL
bodies. The weights are drawn on the device from one torch.Generator in
a few large calls, in float32 (the type they are served in), with the
layouts and init scales of humor_torch's `init_params`; the bodies are
numpy arrays from a numpy seed (the licensed SMPL assets are not in the
image), copied from humor_torch/body_model/smpl.synthetic_smpl_model so
that seed 1234 gives the port's default body.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import constants as C


def _mlp_layout(widths: Sequence[int], skip_dim: int = 0) -> List[tuple]:
    """(fan_in, width) of each layer of ops/mlp.init_mlp."""
    out, prev = [], widths[0]
    for i, width in enumerate(widths[1:]):
        out.append((prev if i == 0 else prev + skip_dim, width, prev))
        prev = width
    return out


def humor_layouts(hcfg, hidden: int) -> Dict[str, List[tuple]]:
    """The HuMoR MLPs' layer shapes (models/humor.init_params)."""
    d_past, L, W = hcfg.past_data_dim, hcfg.latent_size, hidden
    lay = {"encoder": _mlp_layout([d_past + hcfg.input_data_dim] + [W] * 4
                                  + [2 * L]),
           "decoder": _mlp_layout([d_past + L, W, W, 512,
                                   hcfg.output_data_dim], skip_dim=L)}
    if hcfg.conditional_prior:
        lay["prior"] = _mlp_layout([d_past] + [W] * 4 + [2 * L])
    return lay


def humor_weights(hcfg, hidden: int, gen: torch.Generator,
                  decoder_out_scale=1.0) -> Dict:
    """torch.nn.Linear-style uniform(+-1/sqrt(fan_in)) weights and
    biases from one uniform draw; GroupNorm scales 1 and biases 0. The
    decoder's last layer is scaled by `decoder_out_scale`."""
    lay = humor_layouts(hcfg, hidden)
    order = [(name, i, fi, w, prev) for name in sorted(lay)
             for i, (fi, w, prev) in enumerate(lay[name])]
    total = sum(fi * w + w for _, _, fi, w, _ in order)
    dev = gen.device
    u = torch.rand(total, generator=gen, device=dev) * 2.0 - 1.0
    params, o = {name: [] for name in lay}, 0
    for name, i, fi, w, prev in order:
        bound = 1.0 / fi ** 0.5
        layer = {"w": (u[o:o + fi * w] * bound).reshape(fi, w)}
        o += fi * w
        layer["b"] = u[o:o + w] * bound
        o += w
        if i > 0:
            layer["gn_scale"] = torch.ones(prev, device=dev)
            layer["gn_bias"] = torch.zeros(prev, device=dev)
        params[name].append(layer)
    last = params["decoder"][-1]
    last["w"], last["b"] = (last["w"] * decoder_out_scale,
                            last["b"] * decoder_out_scale)
    return params


def vposer_weights(vcfg, gen: torch.Generator) -> Dict:
    """He-normal weights from one normal draw, uniform(+-1/sqrt(fan_in))
    biases from one uniform draw, identity eval-mode BatchNorms
    (models/vposer.init_params)."""
    h, l, p = vcfg.hidden, vcfg.latent_dim, vcfg.num_joints * 3
    lins = [("enc_fc1", p, h), ("enc_fc2", h, h), ("enc_mu", h, l),
            ("enc_logvar", h, l), ("dec_fc1", l, h), ("dec_fc2", h, h),
            ("dec_out", h, vcfg.num_joints * 6)]
    dev = gen.device
    n = torch.randn(sum(a * b for _, a, b in lins), generator=gen,
                    device=dev)
    u = torch.rand(sum(b for _, _, b in lins), generator=gen,
                   device=dev) * 2.0 - 1.0
    params, on, ou = {}, 0, 0
    for name, a, b in lins:
        params[name] = {"w": (n[on:on + a * b] * (2.0 / a) ** 0.5
                              ).reshape(a, b),
                        "b": u[ou:ou + b] / a ** 0.5}
        on, ou = on + a * b, ou + b

    def bn(k):
        return {"scale": torch.ones(k, device=dev),
                "bias": torch.zeros(k, device=dev),
                "mean": torch.zeros(k, device=dev),
                "var": torch.ones(k, device=dev)}

    params["enc_bn1"], params["enc_bn2"] = bn(p), bn(h)
    return params


def gmm_arrays(components: int, dim: int, device) -> tuple:
    """The initial-state prior: equal weights, zero means, identity
    covariances."""
    return (torch.ones(components, device=device) / components,
            torch.zeros(components, dim, device=device),
            torch.eye(dim, device=device).expand(components, dim, dim)
            .clone())


def synthetic_body(seed: int, num_verts: int, num_joints: int = 22,
                   num_betas: int = C.BETA_SIZE) -> Dict[str, np.ndarray]:
    """A procedural SMPL body from a numpy seed: the skeleton of SMPL's
    parent tree, vertices around the bones, smooth skinning weights."""
    rng = np.random.RandomState(seed)
    parents = np.asarray(C.SMPL_PARENTS[:num_joints], np.int32).copy()
    rest_j = np.zeros((num_joints, 3), np.float32)
    rest_j[0] = [0.0, 0.0, 0.9]
    for j in range(1, num_joints):
        off = rng.randn(3).astype(np.float32) * 0.12
        rest_j[j] = rest_j[parents[j]] + off
    host = rng.randint(0, num_joints, size=num_verts)
    v_template = rest_j[host] + rng.randn(num_verts, 3).astype(
        np.float32) * 0.08
    d = np.linalg.norm(v_template[None, :, :] - rest_j[:, None, :], axis=-1)
    j_reg = np.exp(-d / 0.05)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    w = np.exp(-d.T / 0.08)
    w /= w.sum(axis=1, keepdims=True)
    shapedirs = rng.randn(num_verts, 3, num_betas).astype(np.float32) * 0.01
    posedirs = rng.randn(9 * (num_joints - 1),
                         num_verts * 3).astype(np.float32) * 0.001
    faces = rng.randint(0, num_verts, size=(2 * num_verts, 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return {"v_template": f32(v_template), "shapedirs": f32(shapedirs),
            "posedirs": f32(posedirs), "j_regressor": f32(j_reg),
            "lbs_weights": f32(w), "parents": parents,
            "faces": np.asarray(faces, np.int32),
            "vtx_joint_ids": np.zeros((0,), np.int32)}


def body_model(cls, arrays: Dict[str, np.ndarray], device):
    """An SmplModel of either package (`cls`) over the same arrays, the
    tensors on `device`."""
    t = lambda k: torch.as_tensor(arrays[k], device=device)
    return cls(v_template=t("v_template"), shapedirs=t("shapedirs"),
               posedirs=t("posedirs"), j_regressor=t("j_regressor"),
               lbs_weights=t("lbs_weights"), parents=arrays["parents"],
               faces=arrays["faces"], vtx_joint_ids=arrays["vtx_joint_ids"])


def root_centred(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The body with its template moved so that the rest root joint sits
    at the origin, as SMPL's pelvis nearly does (the PROX init puts each
    frame's translation at its cloud's centroid; with the synthetic root
    0.9 m up the fit would start outside the bisquare term's reach)."""
    j0 = arrays["j_regressor"][0] @ arrays["v_template"]
    return {**arrays, "v_template": (arrays["v_template"] - j0).astype(
        np.float32)}
