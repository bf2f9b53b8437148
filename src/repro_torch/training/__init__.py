from repro_torch.training.train import (  # noqa: F401
    AdamWState, init_opt_state, make_train_step)
