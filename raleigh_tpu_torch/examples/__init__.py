# example problems
