def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skipped (inside the test) when "
        "torch.cuda.is_available() is false")
