"""PyTorch port, kernel 2: the plain version of the from-t any-hit kernel vs
the JAX package's (``tiled_t.anyhit_from_t``, its Pallas kernel in
interpret mode), on the same nearest-pass inputs (t, object, bounds rows)
from the JAX nearest kernel.  found must agree on >= 99.9% of hit lanes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import anyhit, plan as pl, table

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled_t

from _torch_cases import SELF_SKIP, self_skip
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

CASES = {"identity": (None, True), "moved": (VIEW, True),
         "max_t": (None, False)}


@pytest.fixture(scope="module")
def results():
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    tile = TILE_PX * TILE_PX
    R = (WIDTH // TILE_PX) * (HEIGHT // TILE_PX) * tile
    dummy = jnp.zeros((R, 3), jnp.float32)
    light = jnp.asarray(LIGHT)
    out = {}
    for name, (vm, no_max_t) in CASES.items():
        jcs = (None if vm is None else jnp.asarray(vm), FOCAL, WIDTH, HEIGHT,
               TILE_PX)
        jt, _ji, jo, _rgb, jb = tiled_t.hits_shaded(
            jprep, dummy, dummy, tile, cfg.mt_eps, light,
            jnp.asarray(cfg.light.color, jnp.float32), cfg.cull_maxv, jcs,
            True, True, want_bounds=1)
        jf = tiled_t.anyhit_from_t(jprep, jt, jo, jb, tile, cfg.mt_eps,
                                   no_max_t, light, jcs, cfg.cull_maxv)
        c = cfg.replace(light=type(cfg.light)(shadow_no_max_t=no_max_t))
        cs = (None if vm is None else torch.from_numpy(vm), FOCAL, WIDTH,
              HEIGHT, TILE_PX)
        caught = []
        spy = table.spy("anyhit_from_t", caught)
        with table.using({"anyhit_from_t": spy}):
            f = anyhit.anyhit_from_t(
                prep, c, torch.tensor(np.asarray(jt)),
                torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jb)),
                pl.camera(prep, cs, torch.tensor(LIGHT)), cs, cfg.cull_maxv)
        out[name] = (np.asarray(jt), np.asarray(jf), f.numpy(), caught[0])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_anyhit_matches_jax(results, case):
    jt, jf, f, _ = results[case]
    hit = np.isfinite(jt)
    assert hit.sum() > 4000
    assert (f[hit] == jf[hit]).mean() > 0.999
    assert f[hit].sum() > 50                    # the shadow is in view
    assert f[~hit].all()                        # miss lanes read True


def test_shadow_plan_layout(results):
    _, _, _, args = results["identity"]
    plan, tri, block_obj = args[0], args[1], args[2]
    assert plan.shape[1] == pl.PLAN_W
    # windows of window_blocks_ah = 4 blocks (128 triangles)
    assert args[6] == TILE_PX and args[7] == 128 and args[8] == 32
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1])
    wins = block_obj.shape[0] // 4
    assert (cnt < wins).all()          # the light-apex test culls windows
    assert (plan[:, 4] == torch.tensor([-64, 0, -64, 0])).all()
    assert (plan[:, 5] == torch.tensor([-64, -64, 0, 0])).all()


@pytest.mark.parametrize("window, obj, want", SELF_SKIP)
def test_anyhit_self_object_skip(window, obj, want):
    """A ray never counts a triangle of its own object; miss lanes start
    found."""
    tensors, rest = self_skip(window, obj)
    found = table.run("anyhit_from_t", *tensors, *rest)
    assert found[0, :16].all()
    assert (found[0, 16:] == want).all()
