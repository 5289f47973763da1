"""Train state, the Adam step and the solver."""
