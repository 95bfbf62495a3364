"""Model stack of the port: params, one-device context, layers, the dense
decoder and the unified ModelAPI (see ROADMAP Queue 1 for what is ported)."""
