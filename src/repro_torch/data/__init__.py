from repro_torch.data.pipeline import DataPipeline, synthetic_batch  # noqa: F401
