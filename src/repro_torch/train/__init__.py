from repro_torch.train.step import (init_state, make_prefill_step,  # noqa
                                    make_serve_step, make_train_step)
from repro_torch.train.loop import TrainLoop, TrainLoopConfig  # noqa: F401
