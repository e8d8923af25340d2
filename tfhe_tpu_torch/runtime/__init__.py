from tfhe_tpu_torch.runtime.scheduler import Circuit, evaluate  # noqa: F401
