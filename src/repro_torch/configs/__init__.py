"""Platform configurations of the paper's experiments."""
