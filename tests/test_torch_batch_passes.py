"""The batch driver's passes and scope, on the CPU (tests moved from
tests/test_torch_batch.py, whose docstring states the rules, to keep
each file's time on one worker down): pass ranges that add up, a
ragged last tile, rttnw_final on the batch and queue drivers and
Russian roulette's raise."""

import pytest
import torch

from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import convert, render, scenes as tscenes

import _torch_helpers as helpers

W, H, SPP, DEPTH = 48, 27, 4, 8
SIZE = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)


def test_pass_ranges_add_up():
    """Passes [0,1) + [1,2) are the samples of passes [0,2)."""
    scene, cam = tscenes.SCENES["chap11"](W, H)
    cfg = helpers.batch_cfgs(SIZE)[1]
    full, n = render.render_image(scene, cam, cfg, 0, device="cpu")
    parts = [render.render_image(scene, cam, cfg, 0, pass_start=i,
                                 n_passes=1, device="cpu") for i in (0, 1)]
    torch.testing.assert_close((parts[0][0] + parts[1][0]) / 2, full,
                               atol=1e-6, rtol=1e-6)
    assert int(parts[0][1]) + int(parts[1][1]) == int(n)


def test_ragged_last_tile():
    """Tiles of 500 pixels leave a ragged last tile of 296: the image and
    the traced count equal the tile driver's, with no padding counted."""
    scene, cam = tscenes.SCENES["chap11"](W, H)
    cfg = helpers.batch_cfgs(SIZE, tile_pixels=500)[1]
    img, n = render.render_image(scene, cam, cfg, 0, device="cpu")
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0,
                                             device="cpu")
    torch.testing.assert_close(img, tile, atol=1e-5, rtol=1e-5)
    assert int(n) == int(n_tile)


@pytest.mark.parametrize("driver", ["batch", "queue"])
def test_out_of_scope_raises(driver):
    """Nothing these scenes need is out of scope in either driver any
    more: rttnw_final's 400 ground boxes (past SOLID_CAP) render since
    #9.5's rest, its forward part (as constant media since #9.4, the
    perlin and image textures since #9.5's first part), and Russian
    roulette since #9.6, with fewer traced segments than without it."""
    j_scene, j_cam = jscenes.SCENES["rttnw_final"](8, 8)
    boxes = convert.scene_from_numpy(helpers.leaves(j_scene))
    cam = convert.camera_from_numpy(helpers.leaves(j_cam))
    spheres, s_cam = tscenes.SCENES["chap11"](8, 8)
    fn = (render.render_image if driver == "batch"
          else render.render_image_queue)
    base = dict(width=8, height=8, spp=2, samples_per_pass=2)
    img, n = fn(boxes, cam, render.RenderConfig(**base), 0, device="cpu")
    assert torch.isfinite(img).all() and int(n) >= 8 * 8 * 2
    short = dict(base, max_depth=8)
    _, n0 = fn(spheres, s_cam, render.RenderConfig(**short), 0, device="cpu")
    img, n1 = fn(spheres, s_cam, render.RenderConfig(**short, rr_depth=1), 0,
                 device="cpu")
    assert torch.isfinite(img).all() and int(n1) < int(n0)
