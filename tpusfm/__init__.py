"""tpusfm — a structure-from-motion / 3D-reconstruction framework in JAX.

Built from scratch in JAX/XLA/Pallas, running on NVIDIA GPUs (and on the CPU
for tests), with the capability surface of the
reference C++ pipeline (RainbowXXX/3DReconstruction — see SURVEY.md):

- ``tpusfm.core``      — SO3/SE3 Lie groups, camera models, triangulation,
                         epipolar geometry (ref: src/component/, src/world/)
- ``tpusfm.features``  — SIFT-class detector + descriptor, batched on-device
                         (ref: src/nonFree/sift/)
- ``tpusfm.matching``  — pair generation, descriptor matching, geometric filter
                         (ref: src/sparseBuilder/sparseBuilder.cpp matchPair/match/filter)
- ``tpusfm.sfm``       — SoA scene containers and the incremental engine
                         (ref: src/actuator/, src/frame/, sparseBuilder reconstruction)
- ``tpusfm.ba``        — Huber-robust Schur-complement bundle adjustment
                         (ref: src/adjuster/BundleAdjuster.h)
- ``tpusfm.dense``     — plane-sweep / patch-match dense depth + fusion
                         (ref: src/denseBuilder/, OpenMVS DensifyPointCloud usage)
- ``tpusfm.parallel``  — device-mesh runtime, sharded matching, distributed BA
- ``tpusfm.io``        — PLY / scene JSON artifacts, EXIF focal priors, images
- ``tpusfm.pipeline``  — staged, resumable pipeline orchestration + config
- ``tpusfm.service``   — HTTP facade with SSE progress events (ref: src/main.cpp)
- ``tpusfm.ops``       — image ops and the fused Pallas matcher (GPU)
"""

__version__ = "0.1.0"
