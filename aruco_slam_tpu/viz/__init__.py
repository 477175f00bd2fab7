"""Host-side visualization sinks (2D overlay, 3D map/trajectory).

The reference renders through OpenCV windows and a Pangolin/OpenGL
binding built from source (reference viewers/viewer_2d.py,
viewers/viewer_3d.py, thirdparty/pangolin_setup.py). Per the
device-first design these are pure host-side sinks fed by device→host pose/map
snapshots: the 2D overlay rasterizes in numpy (no native windowing
dependency), the 3D view renders with matplotlib (headless export) or
the fast numpy rasterizer (viz/render3d — the live follow-camera
window), and both export PNG frames / MP4 (imageio).
Interactive windows (`--display`) go through cv2 when a display
server exists; everything degrades to headless export without one.
"""

from aruco_slam_tpu.viz.viewer2d import Viewer2D
from aruco_slam_tpu.viz.viewer3d import Viewer3D
from aruco_slam_tpu.viz.render3d import render_map_frame

__all__ = ["Viewer2D", "Viewer3D", "render_map_frame"]
