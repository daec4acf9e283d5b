from .pipeline import DataConfig, data_iterator, synth_batch  # noqa: F401
