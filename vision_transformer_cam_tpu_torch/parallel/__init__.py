"""Multi-process layouts of the port (the counterpart of
vision_transformer_cam_tpu/parallel): the data-parallel ('data',) mesh (the
reference's DDP: each rank its rows of the global batch, the gradients and
the batch-global mask max reduced over the ranks, ZeRO-1 in
``train.state.Optimizer``), the sequence-parallel ('data', 'seq') grid, the
tensor-parallel ('data', 'model') grid (``shard_params``: Megatron's layout
of every block's heads and MLP hidden units) and the pipeline's ('data',
'stage') grid (``parallel.pipeline``: the blocks in stages, GPipe's
schedule) of ``torch.distributed`` process groups; ``gather_rows`` is the
differentiable gather of the sequence-parallel training forward.
``worker`` spawns the ranks of any of them on one host."""

from vision_transformer_cam_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout, SeqMesh, ShardedLinear, ambient_mesh, apply_seq_parallel,
    barrier, current_mesh, distributed_init, full_state_dict, gather_rows,
    get_rank,
    get_world_size, is_main_process, load_full_state_dict, local_batch_rows,
    make_mesh, param_pspecs, process_local_slice, reduce_value,
    seq_parallel_mesh, set_mesh, shard_batch, shard_params)
