"""Runnable examples, the port's counterparts of the root `examples/`:

    python -m oclpathtracer_tpu_torch.examples.multi_device    sharded render == one device
    python -m oclpathtracer_tpu_torch.examples.inverse_albedo  albedos through autograd
    python -m oclpathtracer_tpu_torch.examples.train_kernel    class attributes, adjoint kernel
    python -m oclpathtracer_tpu_torch.examples.train_vertices  the moved light, vertex step

Each runs on the card by default (`--device cuda`) and on the host with
`--device cpu` (the kernels' plain versions).
"""
