"""Ray generation, in-memory frames and the synthetic scene, the mesh writer."""
