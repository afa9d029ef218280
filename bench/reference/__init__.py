"""Plain float32 references: the models (one file per configuration, named
after it, loaded by ``bench.harness``) and the prefix-cache router."""
