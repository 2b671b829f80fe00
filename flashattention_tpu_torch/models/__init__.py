"""Model families served by the engine."""
