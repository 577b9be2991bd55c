"""Fleet's strategy and topology."""
