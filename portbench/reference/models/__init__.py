"""Plain reference models, one module a model name of the program's
registry, each with ``build(program) -> nn.Module``."""
