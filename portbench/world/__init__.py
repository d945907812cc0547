"""The benchmark's frame source: a textured corridor rendered on the device
from the run's seed (`render`), seen from a course (`course`) at a KITTI
camera, handed to the port frame by frame from host memory (`source`)."""
