"""Hand-built kernel inputs shared by the CPU and GPU tests of the PyTorch
port.  No JAX here: tests/test_torch_cuda.py imports this on machines
without it.  The cases of the nearest kernels are one 64x64 tile at the image
centre, rays from the origin with focal 400 (rebuilt from the pixel for K1,
explicit for K6).
"""

import torch

from simple_raytracer_tpu_torch.kernels import plan as pl


def _quad_tri(z: float) -> torch.Tensor:
    """One triangle row (v0, e1, e2) in the plane z, covering the tile."""
    return torch.tensor([-500.0, -500.0, z, 2000.0, 0.0, 0.0, 0.0, 2000.0,
                         0.0])


def two_windows(bound: float):
    """Nearest-kernel arguments: two windows of 64 triangles with one real
    triangle each — window 0 at z = 10, window 1 nearer, at z = 5 — walked
    in that order, window 1's entry carrying ``bound``.  Rays reach
    window 0's triangle at t = 10/400; a bound above that (a lie) makes
    the walk stop before window 1."""
    tri = torch.zeros((128, 9))
    tri[0], tri[64] = _quad_tri(10.0), _quad_tri(5.0)
    attr = torch.zeros((128, 4))
    attr[:, 2] = 1.0
    attr[64:, 3] = 1.0
    mat = torch.tensor([[0.1, 0.1, 0.1, 0.0, 0.0, 0.0, 0.2, 1.0]] * 2)
    frame = (torch.tensor([1.0, 0, 0]), torch.tensor([0, 1.0, 0]),
             torch.tensor([0, 0, 1.0]))
    cam = pl.make_cam(None, 400.0, (0.0, 0.0, -100.0), frame)
    plan = torch.zeros((1, pl.PLAN_W), dtype=torch.int32)
    plan[0, :6] = torch.tensor([0, 2, 2, 1, -32, -32])
    b16 = int(torch.tensor([bound]).view(torch.int32)) >> 16
    plan[0, pl.PLAN_AUX + 1] = 1 | (b16 << 16)
    return (plan, tri, attr, mat, cam), (64, 64, 1e-12)


def _tile_rays():
    """The case tile's rays as explicit arrays: o [1, 4096, 3] at the
    origin, d [1, 4096, 3] = (px, py, 400) over pixels -32..31."""
    lane = torch.arange(4096)
    d = torch.stack([(lane % 64 - 32).float(), (lane // 64 - 32).float(),
                     torch.full((4096,), 400.0)], dim=1)
    return torch.zeros((1, 4096, 3)), d[None].contiguous()


def _page_plan(entries):
    """A one-tile list plan over pages: ``entries`` = [(page, bound)] in
    walk order."""
    plan = torch.zeros((1, pl.PLAN_W), dtype=torch.int32)
    plan[0, :4] = torch.tensor([0, 2, len(entries), 1])
    for k, (page, bound) in enumerate(entries):
        b16 = int(torch.tensor([bound]).view(torch.int32)) >> 16
        plan[0, pl.PLAN_AUX + k] = page | (b16 << 16)
    return plan


def two_pages(bound: float):
    """The rays-as-input twin of :func:`two_windows` for the paged nearest
    walk (K6): two pages of 128 triangles with one real triangle each —
    page 0 at z = 10, page 1 nearer, at z = 5 — walked in that order, page
    1's entry carrying ``bound``.  Returns ((plan, tri, o, d), (page_tris,
    eps)); the winner is triangle 128, or 0 when the bound lies."""
    tri = torch.zeros((256, 9))
    tri[0], tri[128] = _quad_tri(10.0), _quad_tri(5.0)
    o, d = _tile_rays()
    return (_page_plan([(0, 0.0), (1, bound)]), tri, o, d), (128, 1e-12)


def coincident_pages():
    """K6 arguments with an exact tie: triangles 5 (page 0) and 130 (page
    1) are the same quad at z = 5, and the plan walks page 1 first with no
    bound that could stop the walk.  Every ray's winner is triangle 5, the
    lower id.  Returns ((plan, tri, o, d), (page_tris, eps))."""
    tri = torch.zeros((256, 9))
    tri[5], tri[130] = _quad_tri(5.0), _quad_tri(5.0)
    o, d = _tile_rays()
    return (_page_plan([(1, 0.0), (0, 0.0)]), tri, o, d), (128, 1e-12)


SELF_SKIP = ((0, 0, False), (0, 1, True), (1, 1, False), (1, 0, True))


def self_skip(window: int, obj: int):
    """Any-hit arguments: windows 0 and 1 (128 triangles each, objects 0
    and 1) both hold a triangle between the hit points and the light; the
    plan walks ``window`` and every ray leaves object ``obj``.  The first
    16 lanes miss.  Expected found per (window, obj): SELF_SKIP."""
    tri = torch.zeros((256, 9))
    tri[0], tri[128] = _quad_tri(-50.0), _quad_tri(-50.0)
    block_obj = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32)
    cam = pl.make_cam(None, 400.0, (0.0, 0.0, -100.0))
    plan = torch.zeros((1, pl.PLAN_W), dtype=torch.int32)
    plan[0, :6] = torch.tensor([0, 1, 1, 1, -32, -32])
    plan[0, pl.PLAN_AUX] = window
    t = torch.full((1, 4096), 0.05)
    t[0, :16] = float("inf")
    objs = torch.full((1, 4096), obj, dtype=torch.int32)
    return (plan, tri, block_obj, t, objs, cam), (64, 128, 32, 1e-12)


def ragged_rays():
    """Any-hit over explicit rays in two tiles of M = 1023 rays (not a
    multiple of 32).  Rays start near the origin toward a light at
    z = -100; tile 0 walks window 0, whose triangle at z = -50 lies before
    the light (t = 0.5), tile 1 walks window 1, whose triangle at z = -150
    lies past it (t = 1.5).  Every third lane points away from the light,
    every seventh leaves object 0, the triangles' own.  Returns (tensors,
    (window_tris, block_size, eps), {no_max_t: expected found [2, 1023]})."""
    m = 1023
    tri = torch.zeros((256, 9))
    tri[0], tri[128] = _quad_tri(-50.0), _quad_tri(-150.0)
    block_obj = torch.zeros(8, dtype=torch.int32)
    plan = torch.zeros((2, pl.PLAN_W), dtype=torch.int32)
    plan[:, :4] = torch.tensor([0, 1, 1, 1])
    plan[1, pl.PLAN_AUX] = 1
    lane = torch.arange(m)
    xy = torch.stack([(lane % 31).float() - 15.0,
                      (lane // 31).float() * 0.5 - 8.0], dim=1)
    o = torch.cat([xy, torch.zeros((m, 1))], dim=1)
    d = torch.tensor([0.0, 0.0, -100.0]) - o
    away = lane % 3 == 0
    d = torch.where(away[:, None], -d, d)
    own = lane % 7 == 0
    self_obj = torch.where(own, 0, 1).to(torch.int32)
    o2, d2 = o.expand(2, m, 3).contiguous(), d.expand(2, m, 3).contiguous()
    hit = ~away & ~own
    want = {True: torch.stack([hit, hit]),
            False: torch.stack([hit, torch.zeros_like(hit)])}
    return ((plan, tri, block_obj, o2, d2, self_obj.expand(2, m).contiguous()),
            (128, 32, 1e-12), want)


def _grouped_plan(entries, masks, mv: int = 248):
    """A one-tile grouped list plan (kernels/plan.py::group_mask_words
    layout): ``entries`` = [(window, bound)] in walk order, ``masks`` their
    4-bit sub-group masks."""
    plan = torch.zeros((1, pl.PLAN_AUX + mv + mv // 8), dtype=torch.int32)
    plan[0, :4] = torch.tensor([0, 2, len(entries), 1])
    for k, ((window, bound), mask) in enumerate(zip(entries, masks)):
        b16 = int(torch.tensor([bound]).view(torch.int32)) >> 16
        plan[0, pl.PLAN_AUX + k] = window | (b16 << 16)
        plan[0, pl.PLAN_AUX + mv + k // 8] |= mask << (4 * (k % 8))
    return plan


GROUP_MASK = 0b0101     # window 1's mask: sub-groups 0 and 2 only


def masked_windows():
    """Grouped nearest-walk arguments (K4): two windows of 64 triangles with
    one quad each covering the tile — window 0 at z = 10, window 1 nearer,
    at z = 5 — both with bound 0, window 1's entry masked to GROUP_MASK.
    A walk that honours the masks gives the lanes of sub-groups 0 and 2
    (1,024 lanes each of the 4,096) triangle 64, the others triangle 0.
    Returns ((plan, tri, o, d), (window_tris, eps, groups), want idx)."""
    tri = torch.zeros((128, 9))
    tri[0], tri[64] = _quad_tri(10.0), _quad_tri(5.0)
    o, d = _tile_rays()
    plan = _grouped_plan([(0, 0.0), (1, 0.0)], [0xF, GROUP_MASK])
    g = torch.arange(4096) // 1024
    want = torch.where((GROUP_MASK >> g) & 1 == 1, 64, 0)[None]
    return (plan, tri, o, d), (64, 1e-12, 4), want


def masked_occluder():
    """Grouped any-hit arguments (K5): M = 1,024 rays from z = 0 toward a
    light at z = -100, four sub-groups of 256 lanes; window 0 (object 0)
    is empty, window 1 (object 0) holds a quad at z = -50 and its entry is
    masked to GROUP_MASK; the rays leave object 1.  A walk that honours
    the masks finds an occluder for sub-groups 0 and 2 only.  Returns
    ((plan, tri, block_obj, o, d, self_obj), (window_tris, block_size,
    eps, no_max_t, groups), want found)."""
    m = 1024
    tri = torch.zeros((256, 9))
    tri[128] = _quad_tri(-50.0)
    block_obj = torch.zeros(8, dtype=torch.int32)
    lane = torch.arange(m)
    o = torch.stack([(lane % 32).float() - 16.0, (lane // 32).float() - 16.0,
                     torch.zeros(m)], dim=1)
    d = torch.tensor([0.0, 0.0, -100.0]) - o
    plan = _grouped_plan([(0, 0.0), (1, 0.0)], [0xF, GROUP_MASK])
    self_obj = torch.ones((1, m), dtype=torch.int32)
    g = lane // 256
    want = ((GROUP_MASK >> g) & 1 == 1)[None]
    return ((plan, tri, block_obj, o[None].contiguous(), d[None].contiguous(),
             self_obj), (128, 32, 1e-12, True, 4), want)


def k1_stress(plan, tri, tri_attr, attr_map, window_tris: int):
    """K1's frame arguments rewritten to reach every kind of work row.  The
    triangle tables are doubled: window w + NW is a copy of window w (NW
    windows), so every hit in a copy ties in t with a lower id.  Tile i
    walks, by i % 4: 0 the range of all 2 NW windows (longer than one span
    of the schedule); 1 its list with each entry followed by its copy (a
    list twice as deep; the copy carries its original's bound, so the
    bounds stay sound); 2 nothing; 3 its own plan.  Returns (plan, tri,
    tri_attr, attr_map or None)."""
    nw = tri.shape[0] // window_tris
    p = plan.clone()
    kind = torch.arange(p.shape[0], device=p.device) % 4
    rng, deep, empty = kind == 0, (kind == 1) & (p[:, 3] == 1), kind == 2
    p[rng, 0], p[rng, 1], p[rng, 3] = 0, 2 * nw, 0
    p[empty, 1], p[empty, 2] = 0, 0
    cnt = p[deep, 2]
    mv = p.shape[1] - pl.PLAN_AUX
    assert int(cnt.max()) * 2 <= mv if cnt.numel() else True
    ent = p[deep, pl.PLAN_AUX:pl.PLAN_AUX + mv // 2]
    dup = ent + nw                       # the copy's window, the same bound
    p[deep, pl.PLAN_AUX:pl.PLAN_AUX + 2 * (mv // 2)] = torch.stack(
        [ent, dup], dim=2).reshape(ent.shape[0], -1)
    p[deep, 2] = 2 * cnt
    twice = (lambda x: None if x is None
             else torch.cat([x, x]).contiguous())
    return p, twice(tri), twice(tri_attr), twice(attr_map)


def k2_stress(plan, tri, block_obj, t, window_tris: int):
    """K2's operands (the fused frame's shadow plan, triangle and block
    tables, t) rewritten as :func:`k1_stress` rewrites K1's (the tables
    doubled; by (tile - 1) % 4 a range row of all 2 NW windows, longer
    than one span, a list twice as deep, an empty row, the plan as it is),
    and every lane of each tile i with i % 8 == 6 a miss.  Returns (plan,
    tri, block_obj, t)."""
    n = plan.shape[0]
    roll = (torch.arange(n, device=plan.device) + 1) % n
    p, t2, _, _ = k1_stress(plan[roll], tri, tri[:, :4], None, window_tris)
    p = p[torch.argsort(roll)]
    miss = torch.arange(n, device=p.device) % 8 == 6
    t = torch.where(miss[:, None], float("inf"), t)
    return p, t2, torch.cat([block_obj, block_obj]).contiguous(), t


def grouped_stress(plan, tri, window_tris: int, groups: int):
    """:func:`k1_stress` of a grouped plan (plan.group_mask_words layout):
    the entry columns rewritten as k1_stress does (the triangle table
    doubled; by tile % 4 a range row of all 2 NW windows, a list twice as
    deep whose copies carry their original's bound and mask, an empty
    row, the plan as it is), the mask words rebuilt to match.  Returns
    (plan, tri)."""
    n, width = plan.shape
    mv = (width - pl.PLAN_AUX) * 8 // 9
    pos = torch.arange(mv, device=plan.device)
    words = plan[:, pl.PLAN_AUX + mv:]
    m4 = (words[:, pos // 8] >> (4 * (pos % 8))) & 0xF        # [n, mv]
    flat, tri2, _, _ = k1_stress(plan[:, :pl.PLAN_AUX + mv].contiguous(),
                                 tri, tri[:, :4], None, window_tris)
    kind = torch.arange(n, device=plan.device) % 4
    deep = (kind == 1) & (plan[:, 3] == 1)
    half = m4[deep, :mv // 2]
    m4 = m4.clone()
    m4[deep, :2 * (mv // 2)] = torch.stack([half, half], dim=2).reshape(
        half.shape[0], -1)
    packed = torch.zeros((n, mv // 8), dtype=torch.int32, device=plan.device)
    for k in range(8):
        packed |= m4[:, k::8] << (4 * k)
    return torch.cat([flat, packed], dim=1).contiguous(), tri2


def k3_stress(plan, tri, gram, window_tris: int, lie: bool = False):
    """K3's operands rewritten to reach every kind of work row:
    :func:`k1_stress` with the Gram table doubled beside the triangles (a
    range row of all 2 NW windows, lists twice as deep, empty rows), then
    tile 2 (an empty row) made a range row of more windows than the plan
    has entries, from window 0 (K3 walks none of it; refine_plan keeps it
    whole), the tables repeated until those windows exist.  ``lie`` sets
    every list entry's bound to the largest finite one, so each slice
    breaks as soon as all its rays have a confident hit.  Returns (plan,
    tri, gram)."""
    p, t, g, _ = k1_stress(plan, tri, gram, None, window_tris)
    mv = p.shape[1] - pl.PLAN_AUX
    if p.shape[0] > 2:
        p[2, 0], p[2, 1], p[2, 3] = 0, mv + 1, 0
        reps = -(-(mv + 1) * window_tris // t.shape[0])
        t, g = t.repeat(reps, 1), g.repeat(reps, 1)
    if lie:
        lst = p[:, 3] == 1
        p[lst, pl.PLAN_AUX:] = (p[lst, pl.PLAN_AUX:] & 0xFFFF) | (0x7F7F << 16)
    return p, t.contiguous(), g.contiguous()
