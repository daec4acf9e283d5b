"""Model configs of the port: the Mirage agent's foundation trunk."""
