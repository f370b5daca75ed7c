"""Training of the LM substrate: AdamW (``optimizer``), learning-rate
schedules (``schedule``), the loss, train, prefill and decode steps
(``step``) and top-k compression of the gossip plane's updates
(``compression``) — the port of the JAX package's ``repro.training``."""
