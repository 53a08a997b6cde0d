"""Pick (or synthesize) camera parameters for a point cloud: the port's
own copy of ``pcc_geo_cnn_v2_tpu/cli/pc_to_camera_params.py`` (reference
``src/utils/pc_to_camera_params.py``), same argv.

With Open3D installed this opens the interactive viewer: frame the cloud,
close the window, and the final camera is written as an Open3D
``PinholeCameraParameters`` JSON, the contract ``ut_run_render``'s
reference consumes. Without Open3D (or with ``--auto``) a deterministic
front-facing camera is derived from the cloud's bounding box.

    python -m pcc_geo_cnn_v2_tpu_torch.cli.pc_to_camera_params in.ply \\
        cam.json [--auto] [--axis 2] [--img_size 1024]
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
from pcc_geo_cnn_v2_tpu_torch.utils.render import have_open3d

logger = logging.getLogger(__name__)

__all__ = ["auto_camera_params", "main"]


def auto_camera_params(points, img_size=1024, axis=2):
    """Deterministic bbox-framed pinhole camera dict (Open3D's JSON
    layout)."""
    pts = np.asarray(points, np.float64)[:, :3]
    center = (pts.min(0) + pts.max(0)) / 2.0
    span = float((pts.max(0) - pts.min(0)).max())
    eye = center.copy()
    eye[axis] += 2.5 * span
    f = img_size  # ~22° fov
    # look-at extrinsic in the Open3D / OpenCV convention: camera +z points
    # at the cloud, y down, x right (rot @ (center - eye) lands on +z)
    fwd = (center - eye) / np.linalg.norm(center - eye)
    up = np.array([0.0, 1.0, 0.0]) if axis != 1 else np.array([0.0, 0.0, 1.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])  # world → camera
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = rot
    extrinsic[:3, 3] = -rot @ eye
    return {
        "class_name": "PinholeCameraParameters",
        "intrinsic": {
            "width": img_size,
            "height": img_size,
            "intrinsic_matrix": [f, 0, 0, 0, f, 0,
                                 img_size / 2 - 0.5, img_size / 2 - 0.5, 1],
        },
        "extrinsic": list(extrinsic.T.reshape(-1)),  # column-major
        "version_major": 1,
        "version_minor": 0,
    }


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="pc_to_camera_params")
    parser.add_argument("input_pc")
    parser.add_argument("output_json")
    parser.add_argument("--img_size", type=int, default=1024)
    parser.add_argument("--axis", type=int, default=2,
                        help="viewing axis for --auto")
    parser.add_argument("--auto", action="store_true",
                        help="skip the interactive picker; derive the "
                             "camera from the bounding box")
    args = parser.parse_args(argv)

    data, _ = pc_io.read_ply(args.input_pc)
    if not args.auto and have_open3d():
        import open3d as o3d

        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(data[:, :3])
        vis = o3d.visualization.Visualizer()
        vis.create_window(width=args.img_size, height=args.img_size)
        vis.add_geometry(pc)
        vis.run()  # the user frames the cloud, then closes the window
        params = vis.get_view_control().convert_to_pinhole_camera_parameters()
        vis.destroy_window()
        o3d.io.write_pinhole_camera_parameters(args.output_json, params)
    else:
        if not args.auto:
            logger.warning("Open3D unavailable; falling back to --auto")
        with open(args.output_json, "w") as f:
            json.dump(auto_camera_params(data, args.img_size, args.axis), f,
                      indent=1)
    logger.info("wrote %s", args.output_json)


if __name__ == "__main__":
    main()
