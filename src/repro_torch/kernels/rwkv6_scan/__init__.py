"""rwkv6_scan: the RWKV6 WKV recurrence over time (kernel B5, rwkv6
prefill and decode)."""
