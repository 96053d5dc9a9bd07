"""The port's data-preparation CLIs (the root `scripts/`' counterparts)."""
