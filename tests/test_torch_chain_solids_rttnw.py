"""The bounce chain past SOLID_CAP on rttnw_final without its media, on
the CPU: tests/test_torch_chain_solids.py's comparison of the port's
render_image(differentiable=True) with rrt_tpu's, by its rule, in a file
of its own so that rrt_tpu's jit of this scene (about 45 s alone) runs
beside that file's, not after it."""

from test_torch_chain_solids import (check_case, check_past_cap,  # noqa: F401
                                     images)

NAME = "rttnw_final_no_media"


def test_render_image_differentiable_matches_rrt_tpu(images):
    check_case(images(NAME), NAME)


def test_solids_past_the_cap_get_position_gradients(images):
    check_past_cap(images(NAME), NAME)
