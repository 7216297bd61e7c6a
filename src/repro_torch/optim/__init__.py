from repro_torch.optim.optimizers import (
    OptConfig,
    init_opt_state,
    opt_state_axes,
    opt_update,
)

__all__ = ["OptConfig", "init_opt_state", "opt_state_axes", "opt_update"]
