"""Device models of the port: the dense DFA arrays and the cascade."""
