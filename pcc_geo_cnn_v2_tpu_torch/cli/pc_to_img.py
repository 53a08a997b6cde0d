"""Point cloud → image: the port's own copy of
``pcc_geo_cnn_v2_tpu/cli/pc_to_img.py`` (reference ``utils/pc_to_img.py``),
same argv.

Uses Open3D's offscreen renderer when it is installed, otherwise the
orthographic splat renderer (``utils/render.ortho_render``); RGB columns
(red, green, blue) of the PLY colour the points.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.pc_to_img in.ply out.png \\
        [--img_size 1024] [--axis 2]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.render import have_open3d, ortho_render

logger = logging.getLogger(__name__)

__all__ = ["main"]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="pc_to_img")
    parser.add_argument("input_pc")
    parser.add_argument("output_img")
    parser.add_argument("--img_size", type=int, default=1024)
    parser.add_argument("--axis", type=int, default=2,
                        help="Projection axis for the ortho renderer.")
    args = parser.parse_args(argv)

    data, names = pc_io.read_ply(args.input_pc)
    pts = data[:, :3]
    colors = None
    if all(c in names for c in ("red", "green", "blue")):
        colors = data[:, [names.index(c) for c in ("red", "green", "blue")]]

    if have_open3d():
        import open3d as o3d

        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(pts)
        if colors is not None:
            pc.colors = o3d.utility.Vector3dVector(colors / 255.0)
        vis = o3d.visualization.Visualizer()
        vis.create_window(visible=False, width=args.img_size,
                          height=args.img_size)
        vis.add_geometry(pc)
        vis.capture_screen_image(args.output_img, do_render=True)
        vis.destroy_window()
    else:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img = ortho_render(pts, colors, axis=args.axis,
                           img_size=args.img_size)
        plt.imsave(args.output_img, np.clip(img, 0, 1))
    logger.info("wrote %s", args.output_img)


if __name__ == "__main__":
    main()
