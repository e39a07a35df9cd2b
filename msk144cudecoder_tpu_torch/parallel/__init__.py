"""Multi-device decode: frequency-shard and time-block parallel.

Port of msk144cudecoder_tpu/parallel/: the reference's grid over frequency
channels becomes a split of the frequency grid over devices, and the
streaming window axis a data-parallel time axis (sharding.py); several
processes join through torch.distributed (multihost.py, cli.py).
"""

from .sharding import MeshDecoder, make_mesh, stream_to_windows

__all__ = ["MeshDecoder", "make_mesh", "stream_to_windows"]
