"""tacex_tpu — batched vision-based tactile sensor simulation and RL framework.

A from-scratch JAX/XLA rebuild of the capabilities of TacEx
(reference: DH-Ng/TacEx): GelSight tactile sensor simulation (Taxim optical,
FOTS marker motion, FEM marker flow), batched rigid-body physics with depth
rendering (replacing Isaac Sim/PhysX/RTX), a batched incremental-potential-
contact FEM soft-body solver (replacing libuipc/CUDA), Isaac-Lab-style RL
task environments, and PPO training — all as pure-functional, jit/vmap/
shard_map-friendly JAX programs that scale over a device mesh.

Layer map (mirrors reference SURVEY.md §1, re-architected for batched JAX):
  core/     — config system, math, pytree state (replaces isaaclab.utils)
  ops/      — XLA building blocks: separable blur, analytic SDFs
  sensors/  — GelSightSensor facade + taxim / fots / fem approaches
  physics/  — rigid (batched articulation + contact) and soft (IPC FEM)
  render/   — depth "camera": SDF heightmap rasterizer (replaces RTX/TiledCamera)
  envs/     — functional Direct-RL-style task environments + registry
  rl/       — PPO and SAC (jax.numpy + optax), dict-obs CNN encoder
  parallel/ — device-mesh / sharding helpers (env axis over the devices)
"""

__version__ = "0.1.0"

from . import core  # noqa: F401
