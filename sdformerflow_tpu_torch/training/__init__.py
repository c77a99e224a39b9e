"""Config, weight import and the eval step."""
