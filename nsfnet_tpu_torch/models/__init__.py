"""Networks and weight conversion."""
