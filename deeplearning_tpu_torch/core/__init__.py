"""Core pieces shared by every layer: the registry, the numerics mode
and device resolution."""
