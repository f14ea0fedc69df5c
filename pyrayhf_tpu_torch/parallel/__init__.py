"""Mesh sharding for ionogram synthesis, retrieval, 3-D fans and Doppler.

Port of ``pyrayhf_tpu.parallel``: a (batch, freq) mesh of torch devices in
one process (:func:`ionogram_mesh`) and the sharded entry points.
"""

from .mesh import (doppler_batch_sharded, ionogram_mesh,
                   retrieval_step_sharded, retrieve_gradient_batch_sharded,
                   synthesize_ionograms_sharded, trace_fan_3d_aniso_sharded,
                   trace_fan_3d_sharded, vh_height_sharded)

__all__ = ["ionogram_mesh", "synthesize_ionograms_sharded",
           "vh_height_sharded", "retrieval_step_sharded",
           "retrieve_gradient_batch_sharded", "trace_fan_3d_sharded",
           "trace_fan_3d_aniso_sharded", "doppler_batch_sharded"]
