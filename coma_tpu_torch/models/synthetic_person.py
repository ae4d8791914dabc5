"""Procedural articulated-person training data for the person segmenter.

Counterpart of ``coma_tpu/models/synthetic_person.py``: every numpy draw is
made in the same order, so a seed gives the same batches; the rendered
backgrounds go through the port's textured rasterizer and the JPEG
corruption through ``utils/jpeg.py`` (no PIL on the card machine).

The reference's person masks come from a COCO-pretrained PointRend
(``src/generation/segment_human.py:24``); with no pretrained checkpoint
available in a hermetic environment, the in-tree
:class:`~coma_tpu_torch.models.segmentation.PersonSegmenter` is trained on this
generator and the resulting checkpoint is committed
(``coma_tpu/data/person_segmenter.npz``) with an IoU quality gate
(``tests/test_segmenter_checkpoint.py``).

Images emulate the statistics the segmenter sees in the pipeline: one or two
humanoids (capsule-limb stick figures with plausible standing / sitting /
leaning joint angles — the HOI poses the inpainting produces) in
clothing-like two-tone colors over a textured background with furniture-like
distractor shapes (boxes, ellipses, gradients) that must NOT be segmented.
Everything is numpy; deterministic under a seeded ``Generator``.
"""
from __future__ import annotations

import numpy as np

# body-part proportions, in units of "person height"
_PROP = dict(
    head_r=0.09,
    torso_len=0.30,
    torso_r=0.075,
    upper_arm=0.16,
    lower_arm=0.15,
    arm_r=0.030,
    upper_leg=0.22,
    lower_leg=0.22,
    leg_r=0.040,
    neck=0.04,
)


def _capsule_mask(yy, xx, p1, p2, r):
    """Distance-to-segment < r, vectorized over the pixel grid."""
    d = p2 - p1
    L2 = float(d @ d) + 1e-9
    t = ((xx - p1[0]) * d[0] + (yy - p1[1]) * d[1]) / L2
    t = np.clip(t, 0.0, 1.0)
    cx = p1[0] + t * d[0]
    cy = p1[1] + t * d[1]
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def sample_pose(rng, kind=None):
    """Joint angles (radians) for a stick figure. kinds: standing / sitting /
    leaning — the interaction poses of the HOI prompts
    (``constants/generation/prompts.py``: 'sits on', 'leans against', ...)."""
    kind = kind or rng.choice(["standing", "sitting", "leaning"])
    u = rng.uniform
    if kind == "sitting":
        hip, knee = u(1.1, 1.7), u(1.1, 1.9)
    elif kind == "leaning":
        hip, knee = u(0.0, 0.5), u(0.0, 0.5)
    else:
        hip, knee = u(-0.2, 0.35), u(0.0, 0.5)
    return dict(
        lean=u(-0.35, 0.35) if kind != "leaning" else u(-0.7, 0.7),
        shoulder_l=u(-0.6, 2.6),
        shoulder_r=u(-0.6, 2.6),
        elbow_l=u(0.0, 2.2),
        elbow_r=u(0.0, 2.2),
        hip_l=hip + u(-0.25, 0.25),
        hip_r=hip + u(-0.25, 0.25),
        knee_l=knee + u(-0.3, 0.3),
        knee_r=knee + u(-0.3, 0.3),
    )


def draw_person(size, rng, center, height, pose):
    """Rasterize one humanoid. Returns (mask (S, S) bool, parts dict of
    masks) so callers can color head/torso/legs differently."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    P = {k: v * height for k, v in _PROP.items()}
    lean = pose["lean"]
    up = np.array([np.sin(lean), -np.cos(lean)], np.float32)  # torso direction

    pelvis = np.asarray(center, np.float32)
    chest = pelvis + up * P["torso_len"]
    head_c = chest + up * (P["neck"] + P["head_r"])

    def limb(origin, a0, l1, a1_rel, l2):
        """Two-segment limb hanging off ``origin``; angles measured from
        straight-down, positive toward +x."""
        d1 = np.array([np.sin(a0), np.cos(a0)], np.float32)
        mid = origin + d1 * l1
        a1 = a0 + a1_rel
        d2 = np.array([np.sin(a1), np.cos(a1)], np.float32)
        return mid, mid + d2 * l2

    parts = {}
    parts["torso"] = _capsule_mask(yy, xx, pelvis, chest, P["torso_r"])
    parts["head"] = (xx - head_c[0]) ** 2 + (yy - head_c[1]) ** 2 <= P["head_r"] ** 2

    arms = np.zeros((size, size), bool)
    for side, sh, el in (
        (-1, pose["shoulder_l"], pose["elbow_l"]),
        (1, pose["shoulder_r"], pose["elbow_r"]),
    ):
        a0 = lean + side * sh
        mid, end = limb(chest, a0, P["upper_arm"], side * el, P["lower_arm"])
        arms |= _capsule_mask(yy, xx, chest, mid, P["arm_r"])
        arms |= _capsule_mask(yy, xx, mid, end, P["arm_r"])
    parts["arms"] = arms

    legs = np.zeros((size, size), bool)
    for side, hp, kn in (
        (-1, pose["hip_l"], pose["knee_l"]),
        (1, pose["hip_r"], pose["knee_r"]),
    ):
        a0 = lean + side * hp
        mid, end = limb(pelvis, a0, P["upper_leg"], -side * kn, P["lower_leg"])
        legs |= _capsule_mask(yy, xx, pelvis, mid, P["leg_r"])
        legs |= _capsule_mask(yy, xx, mid, end, P["leg_r"])
    parts["legs"] = legs

    mask = parts["torso"] | parts["head"] | parts["arms"] | parts["legs"]
    return mask, parts


def _background(size, rng):
    """Gradient + blotch texture + furniture-like distractor shapes."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    g0, g1 = rng.uniform(0.1, 0.9, size=(2, 3)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    t = (np.cos(ang) * xx + np.sin(ang) * yy)[..., None]
    img = g0 * (1 - t) + g1 * t
    # low-frequency blotches
    coarse = rng.uniform(-0.15, 0.15, size=(size // 16 + 1, size // 16 + 1, 3))
    reps = np.kron(coarse, np.ones((16, 16, 1)))[:size, :size]
    img = np.clip(img + reps, 0, 1)
    # distractor shapes (the "asset": furniture-like boxes and ellipses)
    for _ in range(rng.integers(1, 5)):
        color = rng.uniform(0.05, 0.95, size=3)
        if rng.uniform() < 0.5:
            x0, y0 = rng.integers(0, size - 8, size=2)
            w, h = rng.integers(size // 10, size // 2, size=2)
            img[y0 : min(y0 + h, size), x0 : min(x0 + w, size)] = color
        else:
            cy, cx = rng.integers(size // 8, 7 * size // 8, size=2)
            ry, rx = rng.integers(size // 12, size // 3, size=2)
            yy2, xx2 = np.mgrid[0:size, 0:size]
            e = ((yy2 - cy) / ry) ** 2 + ((xx2 - cx) / rx) ** 2 <= 1
            img[e] = color
    return img.astype(np.float32)


_SKIN = np.array(
    [[0.95, 0.80, 0.69], [0.78, 0.57, 0.44], [0.55, 0.37, 0.26], [0.35, 0.22, 0.15]],
    np.float32,
)


def person_batch(rng, batch: int, size: int = 128):
    """(images (B, S, S, 3) float32 in [0, 1], masks (B, S, S) float32)."""
    imgs = np.empty((batch, size, size, 3), np.float32)
    masks = np.zeros((batch, size, size), np.float32)
    for b in range(batch):
        img = _background(size, rng)
        total = np.zeros((size, size), bool)
        n_person = int(rng.choice([0, 1, 1, 1, 2]))  # mostly single-person
        for _ in range(n_person):
            height = rng.uniform(0.45, 0.95) * size
            cx = rng.uniform(0.25, 0.75) * size
            cy = rng.uniform(0.35, 0.75) * size
            mask, parts = draw_person(size, rng, (cx, cy), height, sample_pose(rng))
            skin = _SKIN[rng.integers(len(_SKIN))] * rng.uniform(0.85, 1.1)
            shirt = rng.uniform(0.05, 0.95, size=3)
            pants = rng.uniform(0.05, 0.95, size=3)
            img[parts["head"]] = np.clip(skin, 0, 1)
            img[parts["arms"]] = np.clip(
                skin if rng.uniform() < 0.5 else shirt, 0, 1
            )
            img[parts["torso"]] = shirt
            img[parts["legs"]] = pants
            total |= mask
        # shading + sensor noise so edges aren't perfectly flat
        shade = 1.0 + rng.uniform(-0.12, 0.12) * np.linspace(-1, 1, size)[None, :, None]
        img = np.clip(img * shade + rng.normal(0, 0.02, img.shape), 0, 1)
        imgs[b] = img
        masks[b][total] = 1.0
    return imgs, masks.astype(np.float32)


# ---------------------------------------------------------------------------
# Domain-hardened generation (VERDICT r2 task 4): composite the capsule
# humans into TEXTURED-RASTERIZER renders — the actual stage-1 background
# distribution the in-loop segmenter sees (render_objects -> inpaint) — and
# pass the composite through SD-style corruptions (blur / noise / JPEG /
# color jitter). Texture+shape pools are split train vs holdout so the
# checkpoint gate can measure a distribution the model never trained on.
# ---------------------------------------------------------------------------


def _tex_checker(rng, s=64):
    k = int(rng.integers(3, 8))
    c0, c1 = rng.uniform(0.1, 0.9, size=(2, 3))
    yy, xx = np.mgrid[0:s, 0:s] // (s // k)
    return np.where(((yy + xx) % 2 == 0)[..., None], c0, c1).astype(np.float32)


def _tex_noise(rng, s=64):
    coarse = rng.uniform(0, 1, size=(s // 8, s // 8, 3))
    return np.kron(coarse, np.ones((8, 8, 1))).astype(np.float32)[:s, :s]


def _tex_stripes(rng, s=64):
    w = int(rng.integers(3, 10))
    c0, c1 = rng.uniform(0.1, 0.9, size=(2, 3))
    xx = np.mgrid[0:s, 0:s][int(rng.integers(2))] // w
    return np.where((xx % 2 == 0)[..., None], c0, c1).astype(np.float32)


def _tex_sine(rng, s=64):
    """Wood-grain-ish sinusoid (HOLDOUT pool)."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    f = rng.uniform(2, 9, size=2)
    ph = rng.uniform(0, 2 * np.pi, size=2)
    base = rng.uniform(0.2, 0.8, size=3)
    mod = 0.35 * np.sin(2 * np.pi * f[0] * xx + ph[0]) * np.cos(
        2 * np.pi * f[1] * yy + ph[1]
    )
    return np.clip(base + mod[..., None] * rng.uniform(0.3, 1.0, size=3), 0, 1).astype(
        np.float32
    )


def _tex_dots(rng, s=64):
    """Polka dots (HOLDOUT pool)."""
    img = np.full((s, s, 3), rng.uniform(0.15, 0.85, size=3), np.float32)
    c = rng.uniform(0.05, 0.95, size=3)
    yy, xx = np.mgrid[0:s, 0:s]
    step = int(rng.integers(8, 16))
    r = rng.uniform(2, step / 2.2)
    img[((yy % step - step / 2) ** 2 + (xx % step - step / 2) ** 2) < r * r] = c
    return img


_TRAIN_TEXTURES = (_tex_checker, _tex_noise, _tex_stripes)
_HOLDOUT_TEXTURES = (_tex_sine, _tex_dots)


def _box(center, half):
    """12-triangle axis-aligned box with per-face UVs over [0, 1]."""
    cx, cy, cz = center
    hx, hy, hz = half
    v = np.array(
        [[sx * hx + cx, sy * hy + cy, sz * hz + cz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    )  # index bit order (x, y, z)
    quads = [  # outward-facing
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    faces, fuv = [], []
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for q in quads:
        faces += [(q[0], q[1], q[2]), (q[0], q[2], q[3])]
        fuv += [(0, 1, 2), (0, 2, 3)]
    return v, np.asarray(faces, np.int64), np.asarray(uvs, np.float32), np.asarray(fuv, np.int64)


def _procedural_scene(rng, holdout: bool):
    """1-3 textured boxes ("furniture") as a TexturedMesh."""
    from coma_tpu_torch.geometry.mesh import TexturedMesh

    tex_fns = _HOLDOUT_TEXTURES if holdout else _TRAIN_TEXTURES
    verts, faces, uvs, fuv, fmat, texs = [], [], [], [], [], []
    n_v = n_uv = 0
    for bi in range(int(rng.integers(1, 4))):
        c = rng.uniform(-0.6, 0.6, size=3)
        c[2] = rng.uniform(0.1, 0.8)
        half = rng.uniform(0.12, 0.55, size=3)
        if holdout and rng.uniform() < 0.5:
            half[2] *= 2.2  # tall shelves: a shape class absent from training
        v, f, u, fu = _box(c, half)
        verts.append(v)
        faces.append(f + n_v)
        uvs.append(u)
        fuv.append(fu + n_uv)
        fmat.append(np.full(len(f), bi, np.int32))
        texs.append(tex_fns[int(rng.integers(len(tex_fns)))](rng))
        n_v += len(v)
        n_uv += len(u)
    return TexturedMesh(
        vertices=np.concatenate(verts),
        faces=np.concatenate(faces),
        uvs=np.concatenate(uvs),
        face_uvs=np.concatenate(fuv),
        face_material=np.concatenate(fmat),
        textures=np.stack(texs),
    )


def rendered_background_pool(
    seed: int, n: int = 32, size: int = 128, holdout: bool = False, device="cuda"
) -> np.ndarray:
    """Pre-render ``n`` stage-1-style backgrounds (textured Lambertian over a
    ground plane, random ring cameras) on ``device`` -> (n, size, size, 3)
    float32."""
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.pipelines.rendering import (
        build_camera_ring,
        render_object_views_textured,
    )

    device = resolve_device(device)

    rng = np.random.default_rng(seed)
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        tm = _procedural_scene(rng, holdout)
        cams = build_camera_ring(
            ortho_scale_world=float(rng.uniform(2.2, 3.6)),
            length_z=0.5,
            view_num=1,
            elevation_deg=float(rng.uniform(5, 30)),
            azimuth_deg=float(rng.uniform(0, 360)),
            resolution=(size, size),
            device=device,
        )
        _, rgb = render_object_views_textured(
            cams[0], tm.vertices, tm, ground_color=float(rng.uniform(0.5, 0.9))
        )
        out[i] = rgb.astype(np.float32) / 255.0
    return out


def sd_corrupt(img: np.ndarray, rng) -> np.ndarray:
    """SD-output-style corruption: gaussian blur, sensor+shot noise, JPEG
    ringing/blocking, per-channel color jitter, gamma. Each applied with
    independent probability, parameters drawn per image."""
    out = img.astype(np.float32)
    if rng.uniform() < 0.5:  # separable box-ish blur (1-2 px)
        k = int(rng.integers(1, 3))
        ker = np.ones(2 * k + 1, np.float32) / (2 * k + 1)
        out = np.apply_along_axis(lambda a: np.convolve(a, ker, "same"), 0, out)
        out = np.apply_along_axis(lambda a: np.convolve(a, ker, "same"), 1, out)
    if rng.uniform() < 0.7:  # gaussian noise
        out = out + rng.normal(0, rng.uniform(0.01, 0.06), out.shape)
    if rng.uniform() < 0.5:  # color jitter: per-channel affine
        out = out * rng.uniform(0.8, 1.2, size=3) + rng.uniform(-0.08, 0.08, size=3)
    if rng.uniform() < 0.4:  # gamma
        out = np.clip(out, 0, 1) ** rng.uniform(0.7, 1.4)
    out = np.clip(out, 0.0, 1.0)
    if rng.uniform() < 0.5:  # real JPEG round-trip (blocking artifacts)
        from coma_tpu_torch.utils.jpeg import jpeg_roundtrip

        out = jpeg_roundtrip((out * 255).astype(np.uint8),
                             quality=int(rng.integers(30, 80))).astype(np.float32) / 255.0
    return out.astype(np.float32)


def person_batch_domain(
    rng,
    batch: int,
    size: int = 128,
    background: str = "procedural",   # procedural | rendered | rendered_holdout
    corrupt: bool = False,
    bg_pool: np.ndarray = None,
    device="cuda",
):
    """Domain-controlled variant of :func:`person_batch`. ``rendered*``
    backgrounds composite the capsule humans over textured-rasterizer scenes
    (pass a :func:`rendered_background_pool` to avoid re-rendering; else one
    is rendered on ``device``)."""
    imgs, masks = person_batch(rng, batch, size)
    if background != "procedural":
        if bg_pool is None:
            bg_pool = rendered_background_pool(
                int(rng.integers(2**31)), n=16, size=size,
                holdout=background == "rendered_holdout", device=device,
            )
        for b in range(batch):
            bg = bg_pool[int(rng.integers(len(bg_pool)))]
            if rng.uniform() < 0.5:
                bg = bg[:, ::-1]
            m = masks[b] > 0.5
            composite = bg.copy()
            composite[m] = imgs[b][m]
            imgs[b] = composite
    if corrupt:
        for b in range(batch):
            imgs[b] = sd_corrupt(imgs[b], rng)
    return imgs, masks
