"""The plain reference of the path tracer, in PyTorch: what a frame and a
frame's gradient are, written down once more without the program.

It imports nothing of the program. It takes the benchmark's inputs (the
scene text, the physics, the camera, the packed sky table and the seeds)
and works out everything else itself. The estimator is the upstream
renderer's (cozis/ray_tracing, src/main.c), with the program's documented
random-number scheme, so that the same seed gives the same draws:

* Philox4x32-10, key (seed, 0x52545443), counter (global pixel, slot // 4),
  word slot % 4; a uniform is the top 24 bits times 2^-24.
* Slots of one sample: 0-1 pixel jitter; bounce b starts at
  2 + b * (3 * ns + 4): per shadow sample three direction uniforms, then
  three for the bounce direction and one for the specular branch.
* Sample i of a frame seeded s is seeded s itself for one sample, else
  s * 7919 + i, wrapped to int32.

A trace here first finds each ray's winner with no gradient (a scan over
every object, the first of equal distances winning), then rebuilds the hit
from the winner's parameters, so that autograd routes every derivative to
the winner as the running-minimum scan would, with a graph that holds one
object per ray and not all of them. Shadow rays take the full scan: the
nearest object's emission. ``dtype`` sets the precision of every float
computation (the benchmark's control runs it in bfloat16).
"""

from __future__ import annotations

import dataclasses
import math

import torch

FIELDS = ("p0", "p1", "albedo", "roughness", "reflectance", "metallic",
          "emission_power", "emission_color")
BIG = 3.4e38
HIT_BELOW = 1e37
NORMALIZE_EPS = 1e-5
ZERO_EPS = 1e-4
STREAM_KEY = 0x52545443
_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF

_DEFAULTS = {"albedo": (0.44, 0.68, 0.84), "roughness": 0.0, "reflectance": 0.2,
             "metallic": 0.0, "emission_power": 0.0, "emission_color": (1.0, 1.0, 1.0),
             "p0": (0.0, 0.0, 0.0), "p1": (1.0, 1.0, 1.0)}


# ---------------------------------------------------------------------------
# Inputs: scene text, camera, sky
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scene:
    """Objects as field tensors (leading axis: object), plus which are
    spheres and the first emitter (-1: none), fixed when the text is read."""

    fields: dict
    is_sphere: tuple
    light: int

    @property
    def n(self) -> int:
        return len(self.is_sphere)


def parse_scene(text: str) -> list[dict]:
    """The scene language: objects "sphere" or "cube", each followed by
    name-value pairs, a value a number or "{x y z}"."""
    toks = text.replace("{", " { ").replace("}", " } ").split()
    objs, i = [], 0
    while i < len(toks):
        kind = toks[i]
        if kind not in ("sphere", "cube"):
            raise ValueError(f"expected an object, got {kind!r}")
        obj = {"sphere": kind == "sphere", **_DEFAULTS}
        i += 1
        while i < len(toks) and toks[i] not in ("sphere", "cube"):
            name = toks[i]
            if toks[i + 1] == "{":
                value = tuple(float(x) for x in toks[i + 2:i + 5])
                i += 6
            else:
                value = float(toks[i + 1])
                i += 2
            if name in ("center", "origin"):
                obj["p0"] = value
            elif name == "radius":
                obj["p1"] = (value,) * 3
            elif name == "size":
                obj["p1"] = value
            elif name in _DEFAULTS:
                obj[name] = value
            else:
                raise ValueError(f"unknown property {name!r}")
        objs.append(obj)
    return objs


def make_scene(text: str, device, dtype=torch.float32) -> Scene:
    objs = parse_scene(text)
    fields = {f: torch.tensor([o[f] for o in objs], dtype=torch.float32).to(device, dtype)
              for f in FIELDS}
    light = next((k for k, o in enumerate(objs) if o["emission_power"] > 0), -1)
    return Scene(fields, tuple(o["sphere"] for o in objs), light)


@dataclasses.dataclass
class V:
    """A 3-vector of tensors (struct of arrays)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V(self.x + o.x, self.y + o.y, self.z + o.z) if isinstance(o, V) else \
            V(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        return V(self.x - o.x, self.y - o.y, self.z - o.z) if isinstance(o, V) else \
            V(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        return V(self.x * o.x, self.y * o.y, self.z * o.z) if isinstance(o, V) else \
            V(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                 self.x * o.y - self.y * o.x)

    def normalize(self):
        """Unchanged when shorter than 1e-5; else times the reciprocal of
        its length, taken once."""
        n2 = self.dot(self)
        pos = n2 > 0
        n = torch.sqrt(torch.where(pos, n2, torch.ones_like(n2)))
        small = ~pos | (n < NORMALIZE_EPS)
        inv = 1.0 / torch.where(small, torch.ones_like(n), n)
        return where(small, self, self * inv)

    def clip01(self):
        """min(max(c, 0), 1) per component (a value on a bound passes half
        of its derivative, as maximum and minimum do)."""
        def one(c):
            return torch.minimum(torch.maximum(c, c.new_zeros(())), c.new_ones(()))
        return V(one(self.x), one(self.y), one(self.z))


def where(mask, a: V, b: V) -> V:
    return V(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
             torch.where(mask, a.z, b.z))


def row_v(t, i) -> V:
    return V(t[i, 0], t[i, 1], t[i, 2])


def wrap_i32(x: int) -> int:
    x &= _MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def sample_seeds(seed: int, spp: int) -> list[int]:
    return [wrap_i32(seed)] if spp == 1 else [wrap_i32(seed * 7919 + i) for i in range(spp)]


@dataclasses.dataclass(frozen=True)
class Frame:
    """What every sample of a frame shares: its size, physics, camera and
    sky. `physics` and `camera` are the configuration's dicts; `sky` is the
    packed (6*S*S,) int32 0x00RRGGBB table and `sky_size` its S."""

    width: int
    height: int
    physics: dict
    camera: dict
    sky: torch.Tensor
    sky_size: int
    dtype: torch.dtype = torch.float32


def _vec_param(values, device, dtype) -> V:
    t = torch.tensor(values, dtype=torch.float32).to(device, dtype)
    return V(t[0], t[1], t[2])


def camera_rays(frame: Frame, device):
    """(position, u, v and w basis, screen width and height, u and v of each
    pixel) of the frame: the pinhole camera of the upstream
    renderer, whose screen height is 2 tan(fov / 2) with the fov in degrees
    handed to tan as radians when physics["fov_degrees_bug"] is set; u = 1 -
    x / (W - 1), v = 1 - y / (H - 1)."""
    cam, ph, dt = frame.camera, frame.physics, frame.dtype
    pos = _vec_param(cam["pos"], device, dt)
    w = (-_vec_param(cam["front"], device, dt)).normalize()
    ub = _vec_param(cam["up"], device, dt).cross(w).normalize()
    vb = w.cross(ub)
    half = ph["fov"] / 2.0
    sh = 2.0 * math.tan(half if ph["fov_degrees_bug"] else math.radians(half))
    sw = frame.width / frame.height * sh
    sw_t = torch.tensor(sw, dtype=torch.float32).to(device, dt)
    sh_t = torch.tensor(sh, dtype=torch.float32).to(device, dt)
    x = torch.arange(frame.width, dtype=torch.float32, device=device).to(dt)
    y = torch.arange(frame.height, dtype=torch.float32, device=device).to(dt)
    u = 1.0 - x / torch.tensor(float(max(frame.width - 1, 1)), device=device, dtype=dt)
    v = 1.0 - y / torch.tensor(float(max(frame.height - 1, 1)), device=device, dtype=dt)
    shape = (frame.height, frame.width)
    u = u[None, :].expand(shape)
    v = v[:, None].expand(shape)
    return pos, ub, vb, w, sw_t, sh_t, u, v


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _mulhilo(m: int, a):
    p0 = m * (a & 0xFFFF)
    p1 = m * (a >> 16)
    hi = ((p0 >> 16) + p1) >> 16
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _MASK
    return hi, lo


def philox(c0, c1, k0: int, k1: int):
    """Philox4x32-10 of counters (c0, c1, 0, 0) held in int64 tensors."""
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 &= _MASK
    k1 &= _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


class Draws:
    """The uniforms of one sample of the frame, slot by slot."""

    def __init__(self, seed: int, frame: Frame, ns: int, device):
        y = torch.arange(frame.height, dtype=torch.int64, device=device)
        x = torch.arange(frame.width, dtype=torch.int64, device=device)
        self.gpix = (y[:, None] * frame.width + x[None, :]) & _MASK
        self.seed = int(seed)
        self.ns = ns
        self.cube = frame.physics["cube_biased_sampling"]
        self.dtype = frame.dtype
        self._gid, self._words = -1, None

    def uniform(self, slot: int):
        g = slot >> 2
        if g != self._gid:
            self._words = philox(self.gpix, torch.zeros_like(self.gpix) + g,
                                 self.seed, STREAM_KEY)
            self._gid = g
        u = (self._words[slot & 3] >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return u.to(self.dtype)

    def direction_at(self, slot: int) -> V:
        ux, uy, uz = self.uniform(slot), self.uniform(slot + 1), self.uniform(slot + 2)
        if self.cube:
            return V(ux * 2.0 - 1.0, uy * 2.0 - 1.0, uz * 2.0 - 1.0).normalize()
        z = ux * 2.0 - 1.0
        phi = uy * (2.0 * math.pi)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return V(r * torch.cos(phi), r * torch.sin(phi), z)

    def base(self, b: int) -> int:
        return 2 + b * (3 * self.ns + 4)

    def shadow(self, b: int) -> V:
        dirs = [self.direction_at(self.base(b) + 3 * s) for s in range(self.ns)]
        return V(torch.stack([d.x for d in dirs]), torch.stack([d.y for d in dirs]),
                 torch.stack([d.z for d in dirs]))

    def direction(self, b: int) -> V:
        return self.direction_at(self.base(b) + 3 * self.ns)

    def branch(self, b: int):
        return self.uniform(self.base(b) + 3 * self.ns + 3)


# ---------------------------------------------------------------------------
# Intersections
# ---------------------------------------------------------------------------


def _inverses(d: V):
    out = []
    for den in (d.x, d.y, d.z):
        zero = den == 0.0
        safe = 1.0 / torch.where(zero, torch.ones_like(den), den)
        out.append((zero, safe, (1.0 / den).detach()))
    return out


def _slab(num, inv):
    zero, safe, raw = inv
    return torch.where(zero, num.detach() * raw, num * safe)


def sphere_t(ro: V, d: V, a, inv2a, center: V, radius):
    """Distance to a sphere along the unit direction d, BIG where none:
    the nearest non-negative root of a strictly positive discriminant."""
    oc = center - ro
    b = -2.0 * oc.dot(d)
    c = oc.dot(oc) - radius * radius
    discr = b * b - 4.0 * a * c
    valid = discr > 0
    sq = torch.sqrt(torch.where(valid, discr, 0.0))
    s0 = (-b - sq) * inv2a
    s1 = (-b + sq) * inv2a
    t = torch.where(s0 < 0, s1, s0)
    return torch.where(valid & (t >= 0), t, big(t.dtype))


def cube_t(ro: V, d: V, inv, lo: V, hi: V):
    """(distance, face normal) of an axis-aligned box by the slab method:
    the x slab first, y then z taking the hit axis only where they strictly
    tighten the entry; an origin inside is a miss."""
    ta = V(_slab(lo.x - ro.x, inv[0]), _slab(lo.y - ro.y, inv[1]), _slab(lo.z - ro.z, inv[2]))
    tb = V(_slab(hi.x - ro.x, inv[0]), _slab(hi.y - ro.y, inv[1]), _slab(hi.z - ro.z, inv[2]))
    px, py, pz = d.x >= 0, d.y >= 0, d.z >= 0
    tmin = V(torch.where(px, ta.x, tb.x), torch.where(py, ta.y, tb.y), torch.where(pz, ta.z, tb.z))
    tmax = V(torch.where(px, tb.x, ta.x), torch.where(py, tb.y, ta.y), torch.where(pz, tb.z, ta.z))
    miss = (tmin.x > tmax.y) | (tmin.y > tmax.x)
    y_t = tmin.y > tmin.x
    near = torch.where(y_t, tmin.y, tmin.x)
    far = torch.where(tmax.y < tmax.x, tmax.y, tmax.x)
    miss = miss | (near > tmax.z) | (tmin.z > far)
    z_t = tmin.z > near
    near = torch.where(z_t, tmin.z, near)
    one = torch.ones_like(near)
    zero = torch.zeros_like(near)
    sx = torch.where(d.x > 0, -one, one)
    sy = torch.where(d.y > 0, -one, one)
    sz = torch.where(d.z > 0, -one, one)
    normal = V(torch.where(~z_t & ~y_t, sx, zero), torch.where(~z_t & y_t, sy, zero),
               torch.where(z_t, sz, zero))
    return torch.where(~miss & (near >= 0), near, big(near.dtype)), normal


def big(dtype) -> float:
    """The no-hit distance: BIG, or the largest finite value of a narrower
    type."""
    return min(BIG, torch.finfo(dtype).max)


def ray_setup(rd: V):
    d = rd.normalize()
    a = d.dot(d)
    return d, a, 0.5 / a, _inverses(d)


def scan(scene: Scene, ro: V, rd: V):
    """Winner index of every ray (-1: none), with no gradient: the running
    minimum over the objects in order, strictly less winning."""
    with torch.no_grad():
        f = scene.fields
        d, a, inv2a, inv = ray_setup(V(rd.x.detach(), rd.y.detach(), rd.z.detach()))
        ro = V(ro.x.detach(), ro.y.detach(), ro.z.detach())
        t_best = torch.full(d.x.shape, big(d.x.dtype), dtype=d.x.dtype, device=d.x.device)
        best = torch.full(d.x.shape, -1, dtype=torch.int64, device=d.x.device)
        for i in range(scene.n):
            p0 = row_v(f["p0"], i)
            if scene.is_sphere[i]:
                t = sphere_t(ro, d, a, inv2a, p0, f["p1"][i, 0])
            else:
                t, _ = cube_t(ro, d, inv, p0, p0 + row_v(f["p1"], i))
            win = t < t_best
            t_best = torch.where(win, t, t_best)
            best = torch.where(win, i, best)
        return torch.where(t_best < HIT_BELOW, best, -1)


@dataclasses.dataclass
class Hit:
    hit: torch.Tensor
    point: V
    normal: V
    albedo: V
    roughness: torch.Tensor
    reflectance: torch.Tensor
    metallic: torch.Tensor
    emission: V
    sphere: torch.Tensor


def take(t, k):
    """t[k] for a per-object vector t and per-ray indices k, as an
    index_select: its backward adds into t with index_add, where indexing's
    backward sorts the indices and sums the many rays of one object in
    sequence, a thousand times slower on the card."""
    return t.index_select(0, k.reshape(-1)).reshape(k.shape)


def rebuild(scene: Scene, obj, ro: V, rd: V) -> Hit:
    """The hit of each ray on its winner `obj` (-1: none), recomputed from
    the winner's parameters with the scan's arithmetic: differentiable in
    the parameters, the origin and the direction."""
    f = scene.fields
    dt = rd.x.dtype
    hit = obj >= 0
    k = obj.clamp(min=0).long()
    is_sph = take(torch.tensor(scene.is_sphere, device=obj.device), k) & hit
    d, a, inv2a, inv = ray_setup(rd)
    p0 = V(*(take(f["p0"][:, c], k) for c in range(3)))
    p1 = V(*(take(f["p1"][:, c], k) for c in range(3)))
    ts = sphere_t(ro, d, a, inv2a, p0, p1.x)
    tc, nc = cube_t(ro, d, inv, p0, p0 + p1)
    t = torch.where(is_sph, ts, tc)
    t_pt = torch.where(hit, t, torch.zeros((), dtype=dt, device=t.device))
    point = ro + d * t_pt
    zero = torch.zeros_like(t_pt)
    z3 = V(zero, zero, zero)
    normal = where(hit, where(is_sph, (point - p0).normalize(), nc), z3)

    def mat(t):
        return torch.where(hit, take(t, k), zero)

    albedo = V(*(mat(f["albedo"][:, c]) for c in range(3)))
    power = f["emission_power"]
    emission = V(*(mat(f["emission_color"][:, c] * power) for c in range(3)))
    return Hit(hit, point, normal, albedo, mat(f["roughness"]), mat(f["reflectance"]),
               mat(f["metallic"]), emission, is_sph)


def shadow_emission(scene: Scene, obj):
    """(hit, emission of the nearest object) of shadow rays whose winners
    are `obj`: only the emission carries a derivative."""
    f = scene.fields
    hit = obj >= 0
    k = obj.clamp(min=0).long()
    power = f["emission_power"]
    zero = torch.zeros((), dtype=power.dtype, device=power.device)
    return hit, V(*(torch.where(hit, take(f["emission_color"][:, c] * power, k), zero)
                    for c in range(3)))


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------


class Winners:
    """Where a trace's winners come from: scanned (and kept, when `keep`),
    or replayed from a list that an earlier scan kept."""

    def __init__(self, scene: Scene, replay: list | None = None, keep: bool = False):
        self.scene = scene
        self.replay = replay
        self.kept = [] if keep else None
        self._i = 0

    def __call__(self, ro: V, rd: V):
        if self.replay is not None:
            obj = self.replay[self._i]
            self._i += 1
            return obj
        obj = scan(self.scene, ro, rd)
        if self.kept is not None:
            self.kept.append(obj.to(torch.int32))
        return obj


def sample_planes(scene: Scene, frame: Frame, seed: int, winners: Winners,
                  counts: list | None = None):
    """One sample of the frame: (radiance V, sky direction V, sky
    throughput V, missed mask). `counts`, when given, gets per bounce the
    lanes alive at its start, those that hit something, those that hit a
    sphere, the accepted shadow samples of lanes that hit, and those of them
    that the light reached (device tensors)."""
    ph, dt = frame.physics, frame.dtype
    dev = frame.sky.device
    f = scene.fields
    pos, ub, vb, w, sw, sh, u, v = camera_rays(frame, dev)
    ns = ph["shadow_samples"] if scene.light >= 0 and ph["shadow_samples"] > 0 else 0
    draws = Draws(seed, frame, ns, dev)
    if ph["pixel_jitter"]:
        u = u + (draws.uniform(0) - 0.5) / torch.tensor(
            float(max(frame.width - 1, 1)), device=dev, dtype=dt)
        v = v + (draws.uniform(1) - 0.5) / torch.tensor(
            float(max(frame.height - 1, 1)), device=dev, dtype=dt)
    shape = u.shape
    cu = (u - 0.5) * sw
    cv = (v - 0.5) * sh
    rd = V(cu * ub.x + cv * vb.x - w.x, cu * ub.y + cv * vb.y - w.y,
           cu * ub.z + cv * vb.z - w.z)
    ro = V(pos.x.expand(shape), pos.y.expand(shape), pos.z.expand(shape))
    zero = torch.zeros(shape, dtype=dt, device=dev)
    one = torch.ones(shape, dtype=dt, device=dev)
    z3 = V(zero, zero, zero)
    contrib = V(one, one, one)
    result = z3
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    sky_dir, sky_contrib = V(one, one, one), z3
    died = torch.zeros(shape, dtype=torch.bool, device=dev)
    if ns:
        li = scene.light
        lp0, lp1 = row_v(f["p0"], li), row_v(f["p1"], li)
        light_origin = lp0 if scene.is_sphere[li] else lp0 + lp1 * 0.5
    spread, weight, offset = ph["shadow_spread"], ph["light_sample_weight"], ph["hit_offset"]
    for b in range(ph["bounces"]):
        d = rd.normalize()
        h = rebuild(scene, winners(ro, rd), ro, rd)
        miss_now = alive & ~h.hit
        sky_dir = where(miss_now, d, sky_dir)
        sky_contrib = where(miss_now, contrib, sky_contrib)
        died = died | miss_now
        active = alive & h.hit
        if ns:
            rand = draws.shadow(b)
            accept = rand.dot(h.normal) > 0
            sdir = (rand * spread + (light_origin - h.point)).normalize()
            sro = h.point + sdir * offset
            hit2, emit2 = shadow_emission(scene, winners(sro, sdir))
            take = accept & hit2
            ssum = V(*(torch.where(take, c, 0.0).sum(dim=0) for c in (emit2.x, emit2.y, emit2.z)))
            num = accept.to(dt).sum(dim=0)
            light = ssum * (1.0 / torch.clamp(num, min=1.0))
            if counts is not None:
                counts.append((alive.sum(), active.sum(), (active & h.sphere).sum(),
                               (accept & active).sum(), (accept & active & hit2).sum()))
        else:
            light = z3
            if counts is not None:
                counts.append((alive.sum(), active.sum(), (active & h.sphere).sum(),
                               zero.sum(), zero.sum()))
        nov = torch.clamp(h.normal.dot(-rd), 0.0, 1.0)
        f0d = 0.16 * h.reflectance * h.reflectance
        omm = 1.0 - h.metallic
        f0 = V(f0d * omm + h.albedo.x * h.metallic, f0d * omm + h.albedo.y * h.metallic,
               f0d * omm + h.albedo.z * h.metallic)
        x = 1.0 - nov
        x2 = x * x
        p5 = x * (x2 * x2)
        fres = V(f0.x + (1.0 - f0.x) * p5, f0.y + (1.0 - f0.y) * p5, f0.z + (1.0 - f0.z) * p5)
        rdir = draws.direction(b)
        rdir = where(rdir.dot(h.normal) < 0, -rdir, rdir)
        result = result + where(active, h.emission * contrib, z3)
        favg = (fres.x + fres.y + fres.z) / torch.tensor(3.0, device=dev, dtype=dt)
        specular = (h.metallic > 0.001) | (draws.branch(b) <= favg)
        refl = rd - h.normal * (2.0 * h.normal.dot(rd))
        out_spec = (rdir * h.roughness + refl).normalize()
        out_dir = where(specular, out_spec, rdir)
        cnew = where(specular, contrib, contrib * h.albedo * omm)
        lit = ~((light.x.abs() < ZERO_EPS) & (light.y.abs() < ZERO_EPS)
                & (light.z.abs() < ZERO_EPS))
        light_on = active & lit
        result = result + where(light_on, light * cnew * weight, z3)
        cnew = where(light_on, cnew * (1.0 - weight), cnew)
        ro = where(active, h.point + out_dir * offset, ro)
        rd = where(active, out_dir, rd)
        contrib = where(active, cnew, contrib)
        alive = active
    return result, sky_dir, sky_contrib, died


def sky_lookup(frame: Frame, d: V) -> V:
    """Nearest texel of the packed cubemap in direction d (unit): the face
    of the dominant axis (ties to the z faces), u and v clamped to [-1, 1],
    mapped to [0, 1], scaled by size - 1 and truncated; bytes / 255."""
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
    # faces: front 0, back 1, left 2, right 3, top 4, bottom 5
    face = torch.where(xd, torch.where(d.x > 0, 3, 2),
                       torch.where(yd, torch.where(d.y > 0, 4, 5),
                                   torch.where(d.z > 0, 0, 1)))
    u = 0.5 * (torch.clamp(u, -1.0, 1.0) + 1.0)
    v = 0.5 * (torch.clamp(v, -1.0, 1.0) + 1.0)
    s = frame.sky_size
    # the clamp changes nothing in float32 (u, v <= 1); a narrower type can
    # round 1 * (s - 1) up to s, or make NaN
    px = (u * (s - 1)).to(torch.int64).clamp(0, s - 1)
    py = (v * (s - 1)).to(torch.int64).clamp(0, s - 1)
    tex = frame.sky[(face.to(torch.int64) * s + py) * s + px]
    k = 1.0 / 255.0
    return V(((tex >> 16) & 0xFF).to(d.x.dtype) * k, ((tex >> 8) & 0xFF).to(d.x.dtype) * k,
             (tex & 0xFF).to(d.x.dtype) * k)


def compose(frame: Frame, planes) -> V:
    """One sample's colour: clip(radiance + sky * throughput * missed)."""
    result, sky_dir, sky_contrib, died = planes
    with torch.no_grad():
        sky = sky_lookup(frame, V(sky_dir.x.detach(), sky_dir.y.detach(), sky_dir.z.detach()))
    miss = died.to(frame.dtype)
    return (result + sky * sky_contrib * miss).clip01()


def render(scene: Scene, frame: Frame, seed: int, spp: int, counts: list | None = None,
           keep: list | None = None):
    """(H, W, 3) mean of `spp` clipped samples of the frame seeded `seed`,
    summed in sample order and scaled by 1 / spp. `keep`, when given, gets
    each sample's winners (for replay_gradient)."""
    total = None
    for s in sample_seeds(seed, spp):
        winners = Winners(scene, keep=keep is not None)
        rgb = compose(frame, sample_planes(scene, frame, s, winners, counts))
        if keep is not None:
            keep.append(winners.kept)
        total = rgb if total is None else total + rgb
    if spp > 1:
        total = total * (1.0 / spp)
    return torch.stack([total.x, total.y, total.z], dim=-1)


def to_uint8(img):
    """What a user is handed: clamp to [0, 1], times 255, truncated."""
    return (torch.clamp(img.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def replay_gradient(scene: Scene, frame: Frame, seed: int, spp: int, kept: list,
                    cotangent):
    """Accumulate into the scene's leaves the gradient of sum(img *
    cotangent), img the frame of render(..., keep=kept), sample by sample:
    the winners are replayed from `kept`, and every derivative flows
    through the rebuilt hits."""
    scale = 1.0 / spp if spp > 1 else 1.0
    for s, winners in zip(sample_seeds(seed, spp), kept):
        rgb = compose(frame, sample_planes(scene, frame, s, Winners(scene, replay=winners)))
        img = torch.stack([rgb.x, rgb.y, rgb.z], dim=-1)
        img.backward(cotangent * scale)
