"""moe_dispatch: the planned MoE dispatch's plan in one launch (kernel B3,
mixtral's MoE layers in prefill and in every decode step)."""
