"""The LM launchers: ``train`` (centralized and FedCore-for-LM training)
and ``serve`` (KV-cache generation).  The JAX package's mesh helpers
and its dry run come with the sharding work (ROADMAP item 17)."""
