def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; the test itself skips "
        "when torch.cuda.is_available() is false")
