"""PyTorch port: the kernel table (kernels/table.py) and the counters'
registry (utils/metrics.py: ``count``, ``counts``, ``reset_counts``).

On the CPU: every role resolves to its plain twin for CPU tensors and
raises for any device but the CPU and CUDA; the roles are exactly the
wrappers that have a plain twin; the ``plan`` and ``shade`` input rules;
``using`` and its nesting, with the calls a spy sees in ``hits``; and the
registry's counts.  On the card (marked ``cuda``, skipped here): under
``table.plain()`` a fused and a gather frame run no kernel of csrc/,
planner and shading included, and equal the default frame's image.
"""

import importlib
import types

import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

# the modules that define kernel wrappers and their plain twins
MODULES = ("kernels.nearest", "kernels.anyhit", "kernels.paged",
           "kernels.prepass", "kernels.plan", "render.integrator",
           "probes.attr", "probes.fixed")
SCENE_FIELDS = ("verts", "vnormals", "tri_normal", "uvs", "obj_color",
                "obj_ambient", "obj_specular", "obj_shininess", "tex_data")
SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("role", sorted(table.roles()))
def test_role_takes_its_plain_twin_on_the_cpu(role):
    """CPU tensors take the plain twin; a tensor on another device (meta)
    is refused, by ``pick`` and by ``run``."""
    assert table.pick(role, torch.zeros(1)) is table.roles()[role].plain
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        table.pick(role, meta)
    with pytest.raises(ValueError):
        table.run(role, meta)


def test_roles_are_the_wrappers_with_a_plain_twin():
    """Every function ``X_plain`` of the kernel modules with a wrapper
    ``X`` (or ``X_cuda``) beside it is one role's twin, and each role's
    pair is such a wrapper and twin; no two roles share a wrapper."""
    pairs = set()
    for name in MODULES:
        mod = importlib.import_module(f"simple_raytracer_tpu_torch.{name}")
        for n, fn in vars(mod).items():
            if not (n.endswith("_plain") and callable(fn)):
                continue
            wrapper = (getattr(mod, n[:-6] + "_cuda", None)
                       or getattr(mod, n[:-6], None))
            if wrapper is not None:
                pairs.add((wrapper, fn))
    roles = table.roles().values()
    assert {(e.cuda, e.plain) for e in roles} == pairs
    assert len({e.cuda for e in roles}) == len(roles)


def _on(device: str, **fields):
    return types.SimpleNamespace(device=torch.device(device), **fields)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_plan_rule(device):
    """The planner's kernel builds list plans on the card; range-only plans
    (``maxv`` <= 0, or past 65,536 windows) and CPU tensors go plain."""
    for maxv, windows, listed in ((248, 1282, True), (0, 1282, False),
                                  (248, 65537, False), (1000, 65536, True)):
        prep = _on(device, num_blocks=2 * windows)
        want = pl.cull_cuda if device == "cuda" and listed else pl.cull_plain
        assert table.pick("plan", prep, maxv, 2, None) is want


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_shade_rule(device):
    """The shading kernel takes CUDA tensors with no record and no
    gradient to carry; a record, or autograd on an input that requires a
    gradient, goes plain, and an input that requires a gradient under
    ``no_grad`` carries none."""
    scene = _on(device, **dict.fromkeys(SCENE_FIELDS))
    x = torch.zeros(3)
    g = torch.zeros(3, requires_grad=True)
    cuda = integrator.shade_cuda if device == "cuda" else \
        integrator.shade_plain

    def pick(o, record=None):
        return table.pick("shade", scene, None, o, x, x, None, x, None,
                          record)
    assert pick(x) is cuda
    assert pick(x, {"obj": x}) is integrator.shade_plain
    assert pick(g) is integrator.shade_plain
    with torch.no_grad():
        assert pick(g) is cuda


@pytest.fixture(scope="module")
def scene():
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=P.bench_focal(SIZE)),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(P.sphere_on_ground(sr.SceneManager(), 1).build(), cfg,
                   device="cpu")
    return prep, cfg


def test_using_sees_the_prepass_walk(scene):
    """A spy in each of ``hits``' roles sees the prepass walk's calls
    (K3, then K1 over the refined plan; groups do not apply), and the
    frame's hits are the unspied ones; the spies count as the plain twins
    they ran."""
    prep, cfg = scene
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, 32, P.bench_focal(SIZE))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    kcfg = cfg.replace(kernel=sr.KernelConfig(prepass=True, groups=4))
    roles = ("prepass", "nearest_rays", "nearest_grouped", "nearest_attrs")
    stores = {r: [] for r in roles}
    want = nearest.hits(prep, kcfg, o, d, 1024, cfg.cull_maxv)
    before = table.calls(twin=True)
    with table.using({r: table.spy(r, stores[r]) for r in roles}):
        got = nearest.hits(prep, kcfg, o, d, 1024, cfg.cull_maxv)
    seen = {"prepass": 1, "nearest_rays": 1, "nearest_grouped": 0,
            "nearest_attrs": 0}
    assert {r: len(s) for r, s in stores.items()} == seen
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    after = table.calls(twin=True)
    assert {r: after[r] - before[r] for r in roles} == seen


def test_using_nests_role_by_role():
    """An inner scope overrides an outer one role by role and each scope
    restores what it found, also when its body raises."""
    a, b = (lambda *x: "a"), (lambda *x: "b")
    x = torch.zeros(1)
    with table.using({"fixed": a, "attr_gather": a}):
        with table.using({"fixed": b}):
            assert table.run("fixed", x) == "b"
            assert table.run("attr_gather", x) == "a"
        assert table.run("fixed", x) == "a"
        with pytest.raises(RuntimeError):
            with table.using(table.plain()):
                raise RuntimeError
        assert table.run("attr_gather", x) == "a"
    assert table._override == {}


def test_counts_what_ran():
    """A call of a role's wrapper or twin counts under its function's key
    (the planner's as plans) once it returns; a stand-in, and a call that
    raises, count nothing; a peak keeps the most; ``reset_counts`` zeroes
    by prefix."""
    e = table.roles()["plan"]
    assert e.key(e.cuda) == "plan.cull_cuda.plans"
    assert e.key(e.plain) == "plan.cull_plain.plans"
    shade = table.roles()["shade"]
    assert shade.key(shade.cuda) == "integrator.shade_cuda.calls"
    bid = torch.tensor([[0, -1]], dtype=torch.int32)
    at = torch.ones((1, 16))
    before = table.calls(twin=True)["attr_gather"]
    table.run("attr_gather", bid, at)
    with table.using({"attr_gather": lambda *a: None}):
        table.run("attr_gather", bid, at)
    with pytest.raises(IndexError):
        table.run("attr_gather", bid + 5, at)
    assert table.calls(twin=True)["attr_gather"] == before + 1
    assert table.launches()["attr_gather"] == 0
    metrics.count("test.peak", 3, peak=True)
    metrics.count("test.peak", 2, peak=True)
    metrics.count("test.sum", 2)
    metrics.count("test.sum")
    assert metrics.counts("test.") == {"test.peak": 3, "test.sum": 3}
    metrics.reset_counts("test.")
    assert metrics.counts("test.") == {}
    assert metrics.counts("attr.")


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["fused", "gather"])
def test_plain_frame_runs_no_csrc_kernel(branch, monkeypatch):
    """Under ``table.plain()`` a fused and a gather frame on the card count
    no CUDA call in any role and launch no kernel of csrc/ (planner and
    shading included: every launch goes through ``build.library``, made
    to raise), and give the default frame's uint8 image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from simple_raytracer_tpu_torch.kernels import build
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch
    scene_of, change = {
        "fused": (P.sphere_on_ground, {}),
        "gather": (P.textured_on_ground, dict(
            light=sr.LightConfig(num_samples=4),
            shading=sr.ShadingConfig(smooth_normals=True)))}[branch]
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=128, height=128,
                                             focal=400.0), **change)
    prep = prepare(scene_of(sr.SceneManager(), 3).build(), cfg,
                   device="cuda")
    assert frame_branch(prep, cfg, 64 * 64) == branch
    img = sr.render(prep, cfg, P.BENCH_LIGHT)
    assert sum(table.calls().values()) > 0
    metrics.reset_counts()

    def no_kernel():
        raise AssertionError("a kernel of csrc/ was launched")
    monkeypatch.setattr(build, "library", no_kernel)
    with table.using(table.plain()):
        ref = sr.render(prep, cfg, P.BENCH_LIGHT)
    assert table.calls() == dict.fromkeys(table.roles(), 0)
    assert table.launches() == dict.fromkeys(table.roles(), 0)
    assert table.calls(twin=True)["plan"] == 2
    assert torch.equal(img, ref)
