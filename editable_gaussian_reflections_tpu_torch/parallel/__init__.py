"""The parallel modes on torch.distributed (twin of the JAX parallel/):
ray data parallelism (sharding.py), the Gaussian-sharded trace and step
(gaussian_sharded.py), and the process mesh they run on (mesh.py)."""
