"""The plain reference of invert's own fit (the port's apps/invert.py at its
defaults): a frame composed with a bilinear float sky and blended with the
soft primary visibility, its squared-error loss against a target, the
gradient by autograd, and Adam written out by hand.

Imports nothing of the program: the ten planes of a sample come from the
plain path tracer (pathtracer.py); what invert adds is written here from
the program's documented behaviour:

* The sky: a cubemap of float planes (6*S*S,) r, g, b, read at each miss
  direction with the bilinear filter: the face and (u, v) of the dominant
  axis (ties to the z faces; an exact |x| == |y| tie with z == 0 saturates
  to the edge), u and v clamped to [-1, 1], mapped to [0, 1] and scaled by
  S - 1; the floor, the next texel clamped to the face's last, the lerp
  along x on both rows and then along y. Differentiable in the direction.
* A sample's colour: clip(radiance + sky * throughput * missed), summed in
  sample order and scaled by 1 / spp.
* The soft silhouettes (temperature T > 0), on the frame's mean: fresh
  unjittered primary rays; the winner's coverage, for a sphere
  sigmoid((r - d_perp) / (T * max(r, 1e-6))) with d_perp the ray's distance
  from the centre (and no coverage behind the camera), for a box the
  sigmoid of its slab overlap (far - max(near, 0)) over T times its mean
  extent, clamped to +-60 of that before the division; the nearest
  non-winner hit's albedo and emission, and for a pixel that misses the
  best-covering object's; the background seen without the winner,
  clip(emission + albedo * sky), or the sky (clipped) where nothing is
  behind; a pixel that misses blends with 1 - its best coverage. The
  result is frame * alpha + background * (1 - alpha).

Adam takes the operations of torch.optim.Adam's single-tensor path in
their order (the first moment by lerp, the update by addcdiv), so that on
the CPU equal gradients give equal leaves. On the card torch.optim.Adam
runs fused multi-tensor kernels that round a few steps otherwise, and the
backward kernels sum with float atomics, so a leaf can come out an ulp
off after the first step; at 96x64 that can turn one path's branch in the
next step, and that path alone moves the loss by a share of a percent.

Departures: none in the arithmetic. Like the program, the winners and
every comparison carry no gradient. ``dtype`` sets the precision of every
float computation (the benchmark's control runs it in bfloat16).
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import pathtracer as pt
from portbench.reference.pathtracer import V, where
from portbench.reference.train import BETA1, BETA2, EPS


@dataclasses.dataclass(frozen=True)
class Sky:
    """A float cubemap: (6*S*S,) planes r, g, b and S."""

    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    size: int

    def to(self, device, dtype) -> "Sky":
        return Sky(self.r.to(device, dtype), self.g.to(device, dtype),
                   self.b.to(device, dtype), self.size)


def face_uv(d: V):
    """(face, u, v) of directions d before the clamp: faces front 0, back 1,
    left 2, right 3, top 4, bottom 5."""
    ax, ay, az = d.x.abs(), d.y.abs(), d.z.abs()
    xd = (ax > ay) & (ax > az)
    yd = (ay > ax) & (ay > az)
    one = torch.ones((), dtype=d.x.dtype, device=d.x.device)
    sx = torch.where(ax > 0, ax, one)
    sy = torch.where(ay > 0, ay, one)
    sz = torch.where(az > 0, az, one)
    z0 = az == 0.0
    uzn = torch.where(d.z > 0, d.x, -d.x)
    vzn = -d.y
    uz = torch.where(z0, torch.sign(uzn) * 4.0, uzn / sz)
    vz = torch.where(z0, torch.sign(vzn) * 4.0, vzn / sz)
    u = torch.where(xd, torch.where(d.x > 0, -d.z, d.z) / sx, torch.where(yd, d.x / sy, uz))
    v = torch.where(xd, -d.y / sx, torch.where(yd, torch.where(d.y > 0, d.z, -d.z) / sy, vz))
    face = torch.where(xd, torch.where(d.x > 0, 3, 2),
                       torch.where(yd, torch.where(d.y > 0, 4, 5),
                                   torch.where(d.z > 0, 0, 1)))
    return face.to(torch.int64), u, v


def bilinear_corners(size: int, d: V):
    """The four flat texel indices (corners 00, 01 = x + 1, 10 = y + 1, 11)
    and the weights wx, wy of the bilinear lookup in directions d."""
    face, u, v = face_uv(d)
    u = 0.5 * (torch.clamp(u, -1.0, 1.0) + 1.0)
    v = 0.5 * (torch.clamp(v, -1.0, 1.0) + 1.0)
    fx, fy = u * (size - 1), v * (size - 1)
    # the clamp changes nothing in float32 (fx, fy <= size - 1); a narrower
    # type could round past the face
    x0 = torch.floor(fx).to(torch.int64).clamp(0, size - 1)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, size - 1)
    x1 = torch.clamp(x0 + 1, max=size - 1)
    y1 = torch.clamp(y0 + 1, max=size - 1)
    corners = [(face * size + y) * size + x for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    return corners, fx - x0.to(fx.dtype), fy - y0.to(fy.dtype)


def bilinear(sky: Sky, d: V) -> V:
    """The sky's radiance in directions d, bilinearly filtered."""
    (k00, k01, k10, k11), wx, wy = bilinear_corners(sky.size, d)

    def texel(k):
        return V(sky.r[k], sky.g[k], sky.b[k])

    c00, c01, c10, c11 = texel(k00), texel(k01), texel(k10), texel(k11)
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


def compose(sky: Sky, planes) -> V:
    """One sample's colour: clip(radiance + sky * throughput * missed)."""
    result, sky_dir, sky_contrib, died = planes
    return (result + bilinear(sky, sky_dir) * sky_contrib * died.to(result.x.dtype)).clip01()


def _slab_coverage(ro: V, d: V, lo: V, hi: V, temp: float, dtype):
    """Smooth coverage of a box along a ray: the sigmoid of its slab overlap
    over temp times its mean extent; an axis-parallel ray is inside or
    outside that slab whole."""
    big = pt.big(dtype)

    def axis(lo_c, hi_c, ro_c, d_c):
        zero = d_c == 0.0
        safe = torch.where(zero, torch.ones_like(d_c), d_c)
        ta = (lo_c - ro_c) / safe
        tb = (hi_c - ro_c) / safe
        tmin = torch.minimum(ta, tb)
        tmax = torch.maximum(ta, tb)
        inside = (ro_c > lo_c) & (ro_c < hi_c)
        tmin = torch.where(zero, torch.where(inside, -big, big), tmin)
        tmax = torch.where(zero, torch.where(inside, big, -big), tmax)
        return tmin, tmax

    nx, xx = axis(lo.x, hi.x, ro.x, d.x)
    ny, xy = axis(lo.y, hi.y, ro.y, d.y)
    nz, xz = axis(lo.z, hi.z, ro.z, d.z)
    near = torch.maximum(torch.maximum(nx, ny), nz)
    far = torch.minimum(torch.minimum(xx, xy), xz)
    margin = far - torch.clamp(near, min=0.0)
    size = torch.clamp((hi.x - lo.x + hi.y - lo.y + hi.z - lo.z) / 3.0, min=1e-6)
    q = temp * size
    margin = torch.minimum(torch.maximum(margin, -60.0 * q), 60.0 * q)
    return torch.sigmoid(margin / q)


def soft_silhouettes(scene: pt.Scene, frame: pt.Frame, sky: Sky, img: V, temp: float) -> V:
    """The frame's mean `img` blended with the soft primary visibility (the
    module docstring)."""
    f, dt = scene.fields, frame.dtype
    dev = frame.sky.device
    pos, ub, vb, w, sw, sh, u, v = pt.camera_rays(frame, dev)
    shape = u.shape
    cu = (u - 0.5) * sw
    cv = (v - 0.5) * sh
    rd0 = V(cu * ub.x + cv * vb.x - w.x, cu * ub.y + cv * vb.y - w.y,
            cu * ub.z + cv * vb.z - w.z)
    ro0 = V(pos.x.expand(shape), pos.y.expand(shape), pos.z.expand(shape))
    d0 = rd0.normalize()
    a = d0.dot(d0)
    inv2a = 0.5 / a
    inv = pt._inverses(d0)
    obj = pt.scan(scene, ro0, rd0)
    hit = obj >= 0
    zero = torch.zeros(shape, dtype=dt, device=dev)
    z3 = V(zero, zero, zero)
    alpha = torch.where(hit, 1.0, 0.0).to(dt)
    t2 = torch.full(shape, pt.big(dt), dtype=dt, device=dev)
    alb2, emis2, alb_o, emis_o = z3, z3, z3, z3
    a_out = zero
    for i in range(scene.n):
        winner = obj == i
        p0 = pt.row_v(f["p0"], i)
        if scene.is_sphere[i]:
            r = f["p1"][i, 0]
            oc = p0 - ro0
            along = oc.dot(d0)
            d_perp = torch.sqrt(torch.clamp(oc.dot(oc) - along * along, min=1e-12))
            a_i = torch.sigmoid((r - d_perp) / (temp * torch.clamp(r, min=1e-6)))
            alpha = torch.where(winner & (along > 0), a_i, alpha)
            cover = torch.where(along > 0, a_i, zero)
            t_i = pt.sphere_t(ro0, d0, a, inv2a, p0, r)
        else:
            hi = p0 + pt.row_v(f["p1"], i)
            a_i = _slab_coverage(ro0, d0, p0, hi, temp, dt)
            alpha = torch.where(winner, a_i, alpha)
            cover = a_i
            t_i, _ = pt.cube_t(ro0, d0, inv, p0, hi)
        albedo = pt.row_v(f["albedo"], i)
        emission = pt.row_v(f["emission_color"], i) * f["emission_power"][i]
        better = ~hit & (cover > a_out)
        a_out = torch.where(better, cover, a_out)
        alb_o, emis_o = where(better, albedo, alb_o), where(better, emission, emis_o)
        tt = torch.where(winner, pt.big(dt), t_i)
        nearer = tt < t2
        t2 = torch.where(nearer, tt, t2)
        alb2, emis2 = where(nearer, albedo, alb2), where(nearer, emission, emis2)
    sky0 = bilinear(sky, d0).clip01()
    bg = where(t2 < pt.HIT_BELOW, (emis2 + alb2 * sky0).clip01(), sky0)
    alpha = torch.where(hit, alpha, 1.0 - a_out)
    bg = where(hit, bg, (emis_o + alb_o * sky0).clip01())
    return img * alpha + bg * (1.0 - alpha)


def render(scene: pt.Scene, frame: pt.Frame, sky: Sky, seed: int, spp: int,
           temp: float):
    """(H, W, 3) frame seeded `seed`: the mean of `spp` clipped samples, then
    the soft silhouettes where temp > 0; differentiable in the scene's
    fields."""
    total = None
    for s in pt.sample_seeds(seed, spp):
        rgb = compose(sky, pt.sample_planes(scene, frame, s, pt.Winners(scene)))
        total = rgb if total is None else total + rgb
    if spp > 1:
        total = total * (1.0 / spp)
    if temp > 0:
        total = soft_silhouettes(scene, frame, sky, total, temp)
    return torch.stack([total.x, total.y, total.z], dim=-1)


def follow(scene_text: str, frame: pt.Frame, sky: Sky, start: dict, fields, target_seed: int,
           step_seeds, spp: int, lr: float, temp: float) -> dict:
    """Adam over `fields` from the leaves `start` ({field: float32 tensor}),
    one step per seed of `step_seeds`, each on the loss
    sum((frame - target)^2) / (W * H * 3), the target an `spp`-sample frame
    of the unperturbed scene seeded `target_seed`. Returns {"losses": [...],
    "first_grad": {field: tensor}, "change": {field: tensor}} (the change of
    each leaf after the last step), float32 whatever the frame's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, dt = frame.sky.device, frame.dtype
    sky = sky.to(dev, dt)
    base = pt.make_scene(scene_text, dev, dt)
    with torch.no_grad():
        target = render(base, frame, sky, target_seed, spp, temp)
    leaves = {f: start[f].to(dev, dt).clone().requires_grad_(True) for f in fields}
    scene = pt.Scene({**base.fields, **leaves}, base.is_sphere, base.light)
    m = {f: torch.zeros_like(x) for f, x in leaves.items()}
    v = {f: torch.zeros_like(x) for f, x in leaves.items()}
    denom = float(frame.width * frame.height * 3)
    losses, first_grad = [], None
    for t, seed in enumerate(step_seeds, 1):
        diff = render(scene, frame, sky, seed, spp, temp).float() - target.float()
        loss = (diff * diff).sum() / denom
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {f: (g if g is not None else torch.zeros_like(x))
                 for (f, x), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        if t == 1:
            first_grad = {f: g.float().clone() for f, g in grads.items()}
        with torch.no_grad():
            c1 = 1.0 - BETA1 ** t
            c2 = 1.0 - BETA2 ** t
            for f, x in leaves.items():
                g = grads[f]
                m[f].lerp_(g, 1.0 - BETA1)
                v[f].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                x.addcdiv_(m[f], (v[f].sqrt() / c2 ** 0.5).add_(EPS), value=-(lr / c1))
    change = {f: (x.detach().float() - start[f].to(dev).float()) for f, x in leaves.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
