"""Multi-process layouts of the port (the counterpart of
vision_transformer_cam_tpu/parallel): the data-parallel ('data',) mesh (the
reference's DDP: each rank its rows of the global batch, the gradients and
the batch-global mask max reduced over the ranks, ZeRO-1 in
``train.state.Optimizer``) and the sequence-parallel ('data', 'seq') grid of
``torch.distributed`` process groups.  ``worker`` spawns the ranks of either
on one host.  Tensor parallelism ('model'), the pipeline ('stage') and
sequence-parallel training are not ported yet (ROADMAP Queue 1 item 10, its
second half)."""

from vision_transformer_cam_tpu_torch.parallel.mesh import (  # noqa: F401
    SeqMesh, ambient_mesh, apply_seq_parallel, barrier, current_mesh,
    distributed_init, get_rank, get_world_size, is_main_process,
    local_batch_rows, make_mesh, process_local_slice, reduce_value,
    seq_parallel_mesh, set_mesh, shard_batch)
