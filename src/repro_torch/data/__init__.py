from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator  # noqa
