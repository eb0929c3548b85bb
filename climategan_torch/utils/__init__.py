"""Config loading and weight conversion."""
