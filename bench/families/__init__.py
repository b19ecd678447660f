"""One module a model family: the program's model for a configuration file,
the weights drawn from the seed, and the family's reference."""
