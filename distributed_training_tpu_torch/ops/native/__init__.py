"""The native host library of the input pipeline (C++, built with g++)."""
