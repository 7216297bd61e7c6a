"""moe_dispatch: capacity positions of the planned MoE dispatch (kernel B3,
mixtral's MoE layers in prefill and in every decode step)."""
