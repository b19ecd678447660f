from repro_torch.kernels.overlay_exec import kernel, ops, ref  # noqa: F401
