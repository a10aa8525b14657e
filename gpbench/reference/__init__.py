"""Plain PyTorch references of the benchmark's models.  Nothing here
imports the program under test or JAX: the references take the inputs the
harness made and work out again whatever the program derives from them."""
