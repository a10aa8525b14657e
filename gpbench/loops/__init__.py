"""Loops that drive the program under test, one module a kind of traffic mix."""
