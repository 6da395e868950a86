"""Field modules, embeddings and weight import."""
