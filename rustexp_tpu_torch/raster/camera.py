"""Camera paths: rustexp_tpu/raster/camera.py, re-exported.

Host-side numpy math with no jax import, reused rather than copied;
importing it from here keeps the port's callers on one package.
"""

from rustexp_tpu.raster.camera import (  # noqa: F401
    CAMERAS, cam_orbit, cam_orbit_closer, cam_orbit_front, cam_pan_back,
    cam_pan_front, camera_eye, smootherstep,
)
