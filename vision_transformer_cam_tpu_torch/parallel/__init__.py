"""Multi-process layouts of the port (the counterpart of
vision_transformer_cam_tpu/parallel): the sequence-parallel (data, seq) grid
of ``torch.distributed`` process groups.  Tensor, data, ZeRO and pipeline
parallelism are not ported yet."""

from vision_transformer_cam_tpu_torch.parallel.mesh import (  # noqa: F401
    SeqMesh, apply_seq_parallel, current_mesh, distributed_init,
    seq_parallel_mesh, set_mesh)
