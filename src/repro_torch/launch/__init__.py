"""Entry points of the port's LM slice: step builders and the serving driver."""
