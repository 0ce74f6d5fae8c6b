"""Model configurations (``--arch`` ids -> ModelConfig)."""
