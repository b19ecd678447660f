from repro_torch.kernels.rmsnorm import kernel, ops, ref  # noqa: F401
