"""The native host library (C++, built with g++ on first use) and the numpy
plain version of its rasterizer."""
