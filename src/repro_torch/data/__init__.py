from .pipeline import DataConfig, SyntheticPipeline, filtered_batch  # noqa
